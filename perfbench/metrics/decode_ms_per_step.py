"""decode_ms_per_step: wall time of the engine iterations that ran decode
substeps and no prefill and no switch, over the decode substeps they ran
(`ServeMetrics.decode_substeps`; a fused dispatch runs N), in ms."""


def read(run):
    t = n = 0
    for s in run.win.spans:
        if (s.d["prefill_tokens"] == 0 and s.d["decode_substeps"] > 0
                and not s.switched):
            t += s.t1 - s.t0
            n += s.d["decode_substeps"]
    return t * 1e3 / n if n else None
