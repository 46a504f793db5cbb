"""mfu: model FLOPs of the tokens the profiled slices put through the
model (2 x the cell's architecture's active weights per token, plus
attention at the observed KV lengths) over the slices' wall time x 989
TFLOP/s (bf16), in %."""
from harness.work import PEAKS, model_flops


def read(run):
    red = run.trace
    if red is None or red["window_s"] <= 0 or red["tokens"] <= 0:
        return None
    f = model_flops(run.arch, run.model, red["tokens"], red["attn_flops"])
    return 100.0 * f / (red["window_s"] * PEAKS["bf16_flops_per_s"])
