"""other_dev_us_per_tok: device time (profiler) outside kernels #1-#10,
mostly MoE dispatch and combine, norms, dense products and sampling, over
the tokens the profiled slices put through the model (prefill plus
decode positions dispatched), in us."""


def read(run):
    red = run.trace
    if red is None or red["tokens"] <= 0:
        return None
    return red["by_group_us"].get("other", 0.0) / red["tokens"]
