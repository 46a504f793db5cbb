"""prefill_tok_s: prompt tokens put through the model
(`ServeMetrics.prefill_tokens`) over the wall time of the engine
iterations that carried them."""


def read(run):
    t = n = 0
    for s in run.win.spans:
        if s.d["prefill_tokens"] > 0:
            t += s.t1 - s.t0
            n += s.d["prefill_tokens"]
    return n / t if t > 0 else None
