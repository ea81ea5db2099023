"""Device operations (kernels, copies, memsets) of the profiled session
over its frames."""


def read(run):
    t = run.trace
    if not t or t["ops"] == 0:
        return None
    return t["ops"] / t["frames"]
