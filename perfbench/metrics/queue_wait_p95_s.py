"""queue_wait_p95_s: the 95th percentile, over the requests due in the
window, of the time from when a request was due to the end of the first
engine step after which it had left WAITING (serving/scheduler.py
admitted it to prefill); one still waiting at the window's end counts
at the time it had waited."""
import numpy as np


def read(run):
    w = run.win
    x = [(r.left_wait if r.left_wait is not None else w.t1) - r.due
         for r in w.recs if r.due < w.t1]
    return float(np.percentile(x, 95)) if x else None
