"""Share of the profiled session's wall in which no device operation
ran: 1 - (union of device intervals) / wall, in %."""


def read(run):
    t = run.trace
    if not t or t["ops"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
