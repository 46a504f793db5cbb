"""tpot_p95_ms: the 95th percentile, over every request that finished in
the window with more than one token, of (finish - first token) / (tokens
- 1), in ms (host clock)."""
import numpy as np


def read(run):
    x = [(r.done - r.first) / (len(r.req.output) - 1) * 1e3
         for r in run.win.recs
         if r.done is not None and r.first is not None
         and len(r.req.output) > 1]
    return float(np.percentile(x, 95)) if x else None
