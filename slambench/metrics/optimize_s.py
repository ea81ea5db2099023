"""Mean synchronized span of PoseGraphOptimizer.optimize, s."""


def read(run):
    v = run.spans.get("optimize")
    return sum(v) / len(v) if v else None
