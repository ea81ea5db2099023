"""Mean synchronized span of GraphicEnd.loop_closure (one batched round:
candidate draw, gather, verification on the device), ms."""


def read(run):
    v = run.spans.get("lc_round")
    return 1e3 * sum(v) / len(v) if v else None
