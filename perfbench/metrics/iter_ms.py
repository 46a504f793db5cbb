"""iter_ms: the window's wall time over the engine iterations run in it
(`MoebiusEngine.step`, serving/engine.py), in ms."""


def read(run):
    n = len(run.win.spans)
    return run.win.seconds * 1e3 / n if n else None
