"""Mean over the window's whole sessions of the wait from the last
run()'s return to the end of save_final_result (final.g2o, findMoreLoops,
optimize, keyframe.txt, final_after.g2o)."""


def read(run):
    return sum(run.finalize) / len(run.finalize) if run.finalize else None
