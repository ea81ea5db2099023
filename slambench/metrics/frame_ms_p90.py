"""90th percentile of the synchronized run() walls in the window, ms."""

import statistics


def read(run):
    if len(run.walls) < 10:
        return None
    return statistics.quantiles(run.walls, n=10, method="inclusive")[8] * 1e3
