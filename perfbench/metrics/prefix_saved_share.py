"""prefix_saved_share: prompt tokens the prefix cache saved in the window
(`ServeMetrics.prefix_tokens_saved`, serving/paging.py) over the prompt
tokens submitted in it, in %."""


def read(run):
    w = run.win
    sub = sum(len(r.req.prompt) for r in w.recs)
    saved = w.counters1["prefix_tokens_saved"] - w.counters0[
        "prefix_tokens_saved"]
    return 100.0 * saved / sub if sub else None
