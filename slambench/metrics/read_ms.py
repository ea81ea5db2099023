"""Mean synchronized span of GraphicEnd.readimage (the frame's files to
device tensors), ms."""


def read(run):
    v = run.spans.get("read")
    return 1e3 * sum(v) / len(v) if v else None
