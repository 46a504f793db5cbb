"""gmm_dev_us_per_tok: kernel #2's device time (the grouped GEMM,
csrc/moe_gemm.cu) over the tokens the profiled slices put through the
model, in us."""


def read(run):
    red = run.trace
    if red is None or red["tokens"] <= 0 or not red["by_group_us"].get("gmm"):
        return None
    return red["by_group_us"]["gmm"] / red["tokens"]
