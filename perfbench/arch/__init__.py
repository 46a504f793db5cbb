"""What the benchmark knows of a model's architecture, one module each.

A configuration file names its module under `"arch"` (`gqa_moe` where it
names none); `harness/spec.py` imports `arch.<name>` once per cell. Each
module takes the configuration's `"model"` dict `m` and gives:

  * `leaf_specs(m)`: (path, shape, std or None for a norm scale, dtype) of
    every weight, in the order `harness/weights.py` draws them;
  * `engine_owned(m)`: the paths of the leaves the engine keeps its own
    copy of, which the caller drops once the engine is built;
  * `attn_sites(m)`: groups of attention layers alike, each a dict of
    `layers`, `kv_bytes_per_pos` (K/V of one position in one layer),
    `qo_bytes_per_tok` (one query in and its output out, one layer),
    `flops_per_key` (one query against one key, one layer) and `window`
    (0: unbounded), which `harness/serve.py` tallies step by step;
  * `active_matmul_params(m)`: the weights one token multiplies through,
    for `harness/work.py`'s model FLOPs;
  * `KERNEL_GROUPS`: device-function name -> kernel group, added to
    `harness/trace.py`'s base table.
"""
