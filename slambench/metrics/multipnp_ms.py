"""Mean synchronized span of GraphicEnd.multipnp (one registration:
matching, RANSAC PnP, gates), ms."""


def read(run):
    v = run.spans.get("multipnp")
    return 1e3 * sum(v) / len(v) if v else None
