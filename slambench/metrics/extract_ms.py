"""Mean synchronized span of a frame's extraction (_extract_present), ms."""


def read(run):
    v = run.spans.get("extract")
    return 1e3 * sum(v) / len(v) if v else None
