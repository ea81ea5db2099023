"""Milliseconds of device time a frame costs, over the whole window of an
untraced run: the union of every device operation's interval in the
window (torch.profiler's device activity) over the frames processed in
it, finalizes included. None where nothing was collected (a CPU run)."""


def read(run):
    if not run.window_busy_s or not run.frames:
        return None
    return run.window_busy_s * 1e3 / run.frames
