"""attn_roofline: kernel #1 (csrc/paged_attention.cu) against its roofline.
The least time is, step by step, the larger of the bytes its rows need at
their observed KV lengths (K/V read once, Q in and O out once) over
3.35 TB/s and their attention FLOPs over 989 TFLOP/s; the share is that
time over #1's device time in the profiled slices, in %."""


def read(run):
    red = run.trace
    if red is None:
        return None
    t = red["by_group_us"].get("attn", 0.0) / 1e6
    if t <= 0 or red["attn_min_s"] <= 0:
        return None
    return 100.0 * red["attn_min_s"] / t
