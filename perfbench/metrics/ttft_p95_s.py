"""ttft_p95_s: the 95th percentile, over every request due in the window,
of the time from when it was due to when its first token reached the
host. A request without a first token by the window's end counts at the
time it had waited then."""
import numpy as np


def read(run):
    w = run.win
    x = [(r.first if r.first is not None else w.t1) - r.due
         for r in w.recs if r.due < w.t1]
    return float(np.percentile(x, 95)) if x else None
