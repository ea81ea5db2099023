"""Mean synchronized span of GraphicEnd.find_more_loops, s."""


def read(run):
    v = run.spans.get("find_more_loops")
    return sum(v) / len(v) if v else None
