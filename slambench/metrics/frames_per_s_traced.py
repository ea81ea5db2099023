"""Frames processed in the traced run's window (every session's) over the
window's seconds: the host-clock rate of a run whose spans synchronize
around the layers and whose first session is profiled. Per layer: on the
hosts seen the rate follows the host's speed, which drifts by 10-17%
between runs of identical work, too far for an end-to-end bound."""


def read(run):
    return run.frames / run.window_s
