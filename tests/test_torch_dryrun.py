"""The port's dry run (repro_torch/launch/dryrun.py, configs/shapes.py) and
the meta case of the kernel dispatch.

repro's dry run sets XLA_FLAGS to 512 host devices as its first statement,
so everything of repro's that these tests compare against runs in two
subprocesses, started together, whose results come back as JSON: one for
shapes, cc_for, analytic_terms, param_specs and the compressed all-reduce
on a 4-device mesh; one that lowers and compiles small cells on host
meshes for their memory analysis. The port's side runs here, on the CPU
and on `meta`, at tiny sizes.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests._torch_common import (TINY_DENSE_KW, TINY_MOE_KW, port_tiny_dense,
                                 port_tiny_moe)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CHIPS = (1, 8, 16, 256, 512)
CC_CASES = [("qwen3-4b", 8, "tp", 8, 32768), ("qwen3-4b", 8, "ep", 8, 32768),
            ("qwen3-235b-a22b", 8, "tp", 8, 32768),
            ("qwen3-235b-a22b", 16, "ep", 3, 4096),
            ("paligemma-3b", 8, "tp", 2, 32768),
            ("paligemma-3b", 2, "ep", 5, 1000),
            ("mixtral-8x7b", 4, "tp", 1, 4096),
            ("zamba2-2.7b", 8, "ep", 8, 32768),
            ("whisper-base", 16, "tp", 4, 416)]
WORLDS = {"pod1": (None, 8), "pod2": (None,)}
COMP_SHAPE = (4, 3, 64)
TINY = {"tiny_moe": ["mixtral-8x7b", TINY_MOE_KW],
        "tiny_dense": ["internlm2-1.8b", TINY_DENSE_KW]}
FAMILY_CFGS = ["tiny_moe", "tiny_dense", "qwen2-moe-a2.7b", "paligemma-3b",
               "mamba2-780m", "zamba2-2.7b", "whisper-base"]
SPEC_MESH = (2, 2)                    # (data, model) of the param_specs case
PAGE = 4
# (config, layout, (data, model), kind, seq, batch): the cells both dry runs
# lower at small sizes for the per-rank argument bytes
LOWER_CELLS = [
    ("tiny_moe", "tp", (1, 2), "decode", 24, 8),
    ("tiny_moe", "ep", (1, 2), "decode", 24, 8),
    ("tiny_moe", "tpep", (2, 2), "decode", 24, 8),
    ("tiny_dense", "tp", (1, 2), "decode", 24, 8),
    ("tiny_dense", "ep", (1, 2), "decode", 24, 8),
    ("tiny_moe", "ep", (2, 2), "prefill", 16, 4),
    ("qwen2-moe-a2.7b", "tpep", (2, 2), "decode", 24, 8),
    ("paligemma-3b", "ep", (1, 2), "decode", 24, 8),
    ("mamba2-780m", "tp", (1, 2), "decode", 24, 8),
    ("zamba2-2.7b", "tp", (1, 2), "decode", 24, 8),
    ("whisper-base", "ep", (1, 2), "decode", 24, 8),
    ("whisper-base", "tp", (1, 2), "prefill", 16, 4),
    ("mamba2-780m", "tp", (1, 2), "prefill", 16, 4),
    ("zamba2-2.7b", "tp", (1, 2), "train", 16, 4),
    ("whisper-base", "ep", (1, 2), "train", 16, 4),
]

CFG_OF = r"""
def cfg_of(name):
    if name in args["tiny"]:
        base, kw = args["tiny"][name]
        return get_config(base).reduced(**kw, param_dtype=jnp.float32,
                                        compute_dtype=jnp.float32)
    return get_config(name).reduced()


def keypath(p):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
"""

REPRO_CODE = r"""
import json
from types import SimpleNamespace
import repro.launch.dryrun as d          # sets XLA_FLAGS (512 devices) first
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import ARCHS, get_config
from repro.configs import shapes as sh
from repro.distributed.compression import make_compressed_allreduce

args = json.loads(ARGS)
""" + CFG_OF + r"""
out = {"PRODUCTION_CHIPS": sh.PRODUCTION_CHIPS,
       "LONG_OK_FAMILIES": list(sh.LONG_OK_FAMILIES),
       "SHAPES": {k: [v.name, v.seq_len, v.global_batch, v.kind]
                  for k, v in sh.SHAPES.items()},
       "cells": {}, "cc": [], "analytic": {}, "specs": {}}
for arch in ARCHS:
    cfg = get_config(arch)
    for sn, s in sh.SHAPES.items():
        ok, why = sh.cell_applicable(cfg, s)
        specs = {k: [list(v.shape), str(v.dtype)]
                 for k, v in sh.train_input_specs(cfg, s).items()}
        out["cells"][f"{arch}|{sn}"] = {
            "long_ok": sh.long_ok(cfg), "applicable": [ok, why],
            "specs": specs,
            "for_chips": {str(c): [f.name, f.seq_len, f.global_batch, f.kind]
                          for c in args["chips"]
                          for f in [sh.shape_for_chips(s, c)]},
            "layouts": [str(l) for l in d.default_layouts(cfg, s)]}
        for kind, worlds in args["worlds"].items():
            for w in worlds:
                g = 16 if w is None else w
                shp = ({"pod": 2, "data": 16, "model": g} if kind == "pod2"
                       else {"data": 16, "model": g})
                mesh = SimpleNamespace(shape=shp)
                for lo in d.default_layouts(cfg, s):
                    out["analytic"][f"{arch}|{sn}|{kind}|{w}|{lo}"] = \
                        d.analytic_terms(cfg, s, lo, mesh)
for arch, G, lo, gb, seq in args["cc"]:
    c = d.cc_for(get_config(arch), G, lo, gb, seq)
    out["cc"].append([c.page_size, c.pages_ep, c.max_pages_per_req])
rng = np.random.default_rng(0)
g = rng.standard_normal(args["comp_shape"]).astype(np.float32)
mesh = compat.make_mesh((4,), ("data",), devices=jax.devices()[:4])
fn = make_compressed_allreduce(mesh, "data")
res = jnp.zeros(g.shape, jnp.float32)
steps = []
for i in range(3):
    o, res = fn(jnp.asarray(g * (i + 1)), res)
    steps.append([np.asarray(o).tolist(), np.asarray(res).tolist()])
out["compressed"] = {"g": g.tolist(), "steps": steps}
# param_specs' shard count of every leaf of each family's packed tree
from repro.core.layouts import pack_params, param_specs
from repro.models.registry import init_params
dp, G = args["spec_mesh"]
sizes = {"data": dp, "model": G}
for name in args["families"]:
    cfg = cfg_of(name)
    for lo in ["tp", "ep"] + (["tpep"] if cfg.is_moe else []):
        ge = dp * G if lo == "tpep" else None
        tree = jax.eval_shape(lambda: pack_params(
            cfg, init_params(cfg, jax.random.PRNGKey(0)), lo, G,
            expert_G=ge))
        specs = param_specs(cfg, tree, lo)
        flat = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        out["specs"][f"{name}|{lo}"] = {
            keypath(p): int(np.prod([sizes[a] for e in sp if e is not None
                                     for a in ((e,) if isinstance(e, str)
                                               else e)]))
            for p, sp in flat[0]}
print("JSON" + json.dumps(out))
"""

# repro's side of LOWER_CELLS: each cell lowered and compiled on a host mesh;
# per argument leaf, its bytes on one device under the lowering's sharding
# (None where the compiled step does not read it: XLA drops an argument no
# op reads, and its memory analysis does not count it)
REPRO_LOWER = r"""
import json
import repro.launch.dryrun as d          # sets XLA_FLAGS (512 devices) first
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.configs import get_config
from repro.configs.shapes import ShapeSpec
from repro.training.train_loop import build_train_step

args = json.loads(ARGS)
""" + CFG_OF + r"""
out = {}
for name, lo, (dp, G), kind, S, B in args["cells"]:
    cfg = cfg_of(name)
    shape = ShapeSpec("small", S, B, kind)
    mesh = compat.make_mesh((dp, G), ("data", "model"),
                            devices=jax.devices()[:dp * G])
    if kind == "train":
        step, init_fn, _ = build_train_step(
            cfg, mesh, lo, data_axes=("data",), grad_accum=1, donate=False,
            global_batch=B, remat=True, zero=False)
        ps, os_ = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
        low = step.lower(ps, os_, d.input_specs(cfg, shape, mesh, lo))
    else:
        low = d._lower_serve(cfg, shape, mesh, lo, ("data",), G, dp,
                             page=args["page"])
    comp = low.compile()
    leaves = jax.tree_util.tree_flatten_with_path(low.args_info[0])[0]
    # the executable's shardings cover the arguments it kept, in order
    kept = sorted(low._lowering.compile_args["kept_var_idx"])
    shs = dict(zip(kept, jax.tree_util.tree_leaves(comp.input_shardings[0])))
    assert len(shs) == len(kept)
    out["|".join(map(str, [name, lo, dp, G, kind]))] = {
        "argument_size_in_bytes":
            int(comp.memory_analysis().argument_size_in_bytes),
        "leaves": {keypath(p): (int(np.prod(shs[i].shard_shape(a.shape)))
                                * np.dtype(a.dtype).itemsize
                                if i in shs else None)
                   for i, (p, a) in enumerate(leaves)},
        "collectives": sorted(d.parse_hlo_collectives(comp.as_text())
                              ["counts"])}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def repro_procs():
    """Both repro subprocesses, started together; the port's tests that
    need neither run while they work."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    args = {"chips": list(CHIPS), "worlds": WORLDS, "cc": CC_CASES,
            "comp_shape": list(COMP_SHAPE), "tiny": TINY,
            "families": FAMILY_CFGS, "spec_mesh": list(SPEC_MESH),
            "cells": LOWER_CELLS, "page": PAGE}
    head = f"ARGS = {json.dumps(json.dumps(args))}\n"
    procs = {k: subprocess.Popen([sys.executable, "-c", head + code],
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, code in (("data", REPRO_CODE), ("lowered", REPRO_LOWER))}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _result(proc) -> dict:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    line = [ln for ln in out.splitlines() if ln.startswith("JSON")]
    return json.loads(line[-1][4:])


@pytest.fixture(scope="module")
def repro_data(repro_procs):
    return _result(repro_procs["data"])


@pytest.fixture(scope="module")
def repro_lowered(repro_procs):
    return _result(repro_procs["lowered"])


def _archs():
    """The port's configurations that repro has too."""
    from repro_torch.configs import ARCHS, PORT_ONLY
    return [a for a in ARCHS if a not in PORT_ONLY]


# ---------------------------------------------------------------------------
# The port against repro
# ---------------------------------------------------------------------------

def test_shapes_against_repro(repro_data):
    from repro_torch.configs import get_config
    from repro_torch.configs import shapes as sh
    from repro_torch.launch.dryrun import default_layouts
    assert sh.PRODUCTION_CHIPS == repro_data["PRODUCTION_CHIPS"]
    assert list(sh.LONG_OK_FAMILIES) == repro_data["LONG_OK_FAMILIES"]
    assert {k: [v.name, v.seq_len, v.global_batch, v.kind]
            for k, v in sh.SHAPES.items()} == repro_data["SHAPES"]
    assert len(repro_data["cells"]) == len(_archs()) * 4
    for arch in _archs():
        cfg = get_config(arch)
        for sn, s in sh.SHAPES.items():
            want = repro_data["cells"][f"{arch}|{sn}"]
            assert sh.long_ok(cfg) == want["long_ok"]
            assert list(sh.cell_applicable(cfg, s)) == want["applicable"]
            specs = sh.train_input_specs(cfg, s)
            assert all(t.device.type == "meta" for t in specs.values())
            assert {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                    for k, v in specs.items()} == want["specs"]
            for c in CHIPS:
                f = sh.shape_for_chips(s, c)
                assert [f.name, f.seq_len, f.global_batch, f.kind] == \
                    want["for_chips"][str(c)]
            assert [str(lo) for lo in default_layouts(cfg, s)] == \
                want["layouts"]


def test_cc_for_against_repro(repro_data):
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import cc_for
    for (arch, G, lo, gb, seq), want in zip(CC_CASES, repro_data["cc"]):
        c = cc_for(get_config(arch), G, lo, gb, seq)
        assert [c.page_size, c.pages_ep, c.max_pages_per_req] == want


SECONDS = {"t_compute": ("peak_flops", 197e12),
           "t_memory": ("hbm_bw", 819e9),
           "t_collective": ("link_bw", 50e9)}


@pytest.mark.parametrize("arch", _archs())
def test_analytic_terms_against_repro(repro_data, arch):
    """Every shape x default layout at pod1 (repro's world and 8) and pod2:
    the FLOP and byte terms are repro's; the seconds are repro's times the
    TPU v5e constant over the H100's."""
    from types import SimpleNamespace

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.core.cost_model import H100
    from repro_torch.launch.dryrun import analytic_terms, default_layouts
    cfg = get_config(arch)
    n = 0
    for sn, s in SHAPES.items():
        for kind, worlds in WORLDS.items():
            for w in worlds:
                g = 16 if w is None else w
                shp = ({"pod": 2, "data": 16, "model": g} if kind == "pod2"
                       else {"data": 16, "model": g})
                for lo in default_layouts(cfg, s):
                    want = repro_data["analytic"][
                        f"{arch}|{sn}|{kind}|{w}|{lo}"]
                    got = analytic_terms(cfg, s, lo, SimpleNamespace(
                        shape=shp))
                    assert set(got) == set(want)
                    for k, v in want.items():
                        if k in SECONDS:
                            attr, tpu = SECONDS[k]
                            v = v * tpu / getattr(H100, attr)
                        np.testing.assert_allclose(got[k], v, rtol=1e-12,
                                                   atol=0, err_msg=k)
                    n += 1
    assert n >= 12


def test_compressed_allreduce_against_repro(repro_data):
    """The port's all-reduce over 4 stacked data groups == repro's jitted
    shard_map over a 4-device `data` axis, three steps of error feedback."""
    from repro_torch.distributed.compression import make_compressed_allreduce
    fn = make_compressed_allreduce(4)
    g = torch.tensor(repro_data["compressed"]["g"])
    res = torch.zeros_like(g)
    for i, (o_want, r_want) in enumerate(repro_data["compressed"]["steps"]):
        o, res = fn(g * (i + 1), res)
        np.testing.assert_allclose(o.numpy(), np.array(o_want), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(res.numpy(), np.array(r_want), rtol=1e-6,
                                   atol=1e-6)
    # every rank holds the mean; it is near the exact mean of the grads
    assert torch.equal(o[0], o[3])
    assert float((o[0] - (g * 3).mean(0)).abs().max()) < 0.1
    with pytest.raises(ValueError, match="stacked ranks"):
        fn(g[:2], res[:2])


# ---------------------------------------------------------------------------
# The port's own dry run
# ---------------------------------------------------------------------------

def _family_cfg(name):
    from repro_torch.configs import get_config
    if name == "tiny_moe":
        return port_tiny_moe()
    if name == "tiny_dense":
        return port_tiny_dense()
    return get_config(name).reduced()


SMALL_SHAPES = {"train": (16, 4), "prefill": (16, 4), "decode": (24, 8)}


@pytest.mark.parametrize("name", FAMILY_CFGS)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_lower_small_cells(name, kind):
    """`lower` on a tiny or reduced() config of each family at a small
    shape of each kind, on a (2, 2) mesh, for every default layout: ok,
    with positive per-rank bytes and FLOPs and nothing launched."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import dispatch
    from repro_torch.launch.dryrun import MeshShape, default_layouts, lower
    cfg = _family_cfg(name)
    S, B = SMALL_SHAPES[kind]
    shape = ShapeSpec("small", S, B, kind)
    dispatch.reset_counts()
    for lo in default_layouts(cfg, shape):
        rec = lower(cfg, shape, MeshShape({"data": 2, "model": 2}), lo,
                    page=4)
        assert rec["status"] == "ok", (lo, rec)
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["argument_size_in_bytes"] <= mem["argument_total_bytes"]
        assert rec["cost_analysis"]["flops"] > 0
        assert set(rec["analytic"]) >= {"t_compute", "t_memory",
                                        "t_collective"}
    assert sum(dispatch.COUNTS.values()) == 0


STEP_CASES = [("tiny_moe", "tp", 1), ("tiny_moe", "ep", 1),
              ("tiny_moe", "tpep", 1), ("tiny_moe", "ep", 6),
              ("tiny_moe", "tpep", 6), ("tiny_dense", "tp", 1),
              ("tiny_dense", "ep", 6), ("qwen2-moe-a2.7b", "ep", 1),
              ("qwen2-moe-a2.7b", "tp", 6), ("moonlight-16b-a3b", "ep", 1),
              ("moonlight-16b-a3b", "tp", 6)]


@pytest.mark.parametrize("name,layout,Sq", STEP_CASES)
def test_meta_step_matches_cpu_step(name, layout, Sq):
    """The serve step traced on `meta` against the same step run on the
    CPU: outputs of the same shapes and dtypes, argument bytes equal to the
    CPU-built pack and pool's, and the same collectives called."""
    from repro_torch.distributed import ranks
    from repro_torch.kernels import dispatch
    from repro_torch.launch.dryrun import (serve_pack, step_args,
                                           trace_serve_step, tree_bytes)
    from repro_torch.models.registry import init_params
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.steps import build_mixed_step
    cfg = _family_cfg(name)
    mesh = (2, 2) if layout == "tpep" else (1, 2)
    G_exp = 4 if layout == "tpep" else None
    cc = CacheConfig(page_size=4, pages_ep=16, max_pages_per_req=6)
    Bslot = 4
    dispatch.reset_counts()
    rec = trace_serve_step(cfg, mesh, layout, cc, Bslot, Sq, G_exp=G_exp)
    assert sum(dispatch.COUNTS.values()) == 0
    assert rec["cost_analysis"]["kernels"]["paged_attention"]["calls"] == \
        cfg.num_layers * mesh[0]

    pack = serve_pack(cfg, init_params(cfg, 0, device="cpu"), layout,
                      mesh[1], G_exp)
    args = step_args(cfg, cc, mesh, Bslot, Sq, "cpu")
    args[3].fill_(1)                                   # one live token a row
    assert tree_bytes((pack,) + args) == \
        rec["memory"]["argument_total_bytes"]
    step = build_mixed_step(cfg, mesh, layout, cc, Bslot, Sq, device="cpu")
    with ranks.counting() as tally:
        out = step(pack, *args)
    assert [[list(t.shape), str(t.dtype)] for t in out] == rec["outputs"]
    assert dict(tally["counts"]) == rec["hlo_collectives"]["calls_traced"]
    assert out[1] is args[0]                           # the pool, in place


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_moonlight_dry_run_tallies_the_mla_path(kind):
    """moonlight-16b-a3b at full width, traced on `meta` (a small shape of
    each serve kind, mesh (1, 2), tp and ep): every layer stands in for
    #1's MLA path, whose tally is its worst case (every page live), and
    nothing launches."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.paged_attention.ops import mla_worst_case_work
    from repro_torch.launch.dryrun import MeshShape, lower
    cfg = get_config("moonlight-16b-a3b")
    S, B = (64, 4) if kind == "prefill" else (256, 8)
    dispatch.reset_counts()
    for lo in ("tp", "ep"):
        rec = lower(cfg, ShapeSpec("small", S, B, kind),
                    MeshShape({"data": 1, "model": 2}), lo, page=16)
        assert rec["status"] == "ok", (lo, rec)
        k = rec["cost_analysis"]["kernels"]["paged_attention"]
        assert k["calls"] == cfg.num_layers
        assert k["flops"] > 0 and k["bytes"] > 0
    assert sum(dispatch.COUNTS.values()) == 0
    # the tally's arithmetic: every key live, queries at the end
    flops, nb = mla_worst_case_work(2, 3, 4, 16, 576, 512, 5, 16, 2)
    kv = 5 * 16
    keys = sum(min(kv, kv - 4 + i + 1) for i in range(4))
    assert flops == 2 * (576 + 512) * 16 * keys * 2 * 3
    assert nb == (2 * 3 * 4 * 16 * (576 + 512) * 2 + 2 * 3 * kv * 576 * 2
                  + 4 * (2 * 3 * 5 + 2 * 2 * 3))


def test_meta_calls_launch_nothing():
    """Each kernel wrapper given `meta` tensors returns a `meta` tensor of
    its plain version's output shape and dtype (the in-place ones the pool
    itself), tallies its work, and bumps no launch counter."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.expert_reshard import ops as er
    from repro_torch.kernels.kv_pack import ops as kv
    from repro_torch.kernels.moe_gemm.ops import (grouped_matmul,
                                                  grouped_swiglu)
    from repro_torch.kernels.paged_attention.ops import paged_attention
    gen = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=gen)
    i = torch.tensor([1, 3])
    bt = torch.tensor([[[1, 2], [3, 4]]])
    lens = torch.tensor([[5, 7]])
    cases = {
        "paged_attention": lambda m: paged_attention(
            m(r(1, 2, 1, 4, 8)), m(r(1, 6, 4, 2, 8)), m(r(1, 6, 4, 2, 8)),
            m(bt), m(lens), q_offset=m(lens - 1)),
        "grouped_matmul": lambda m: grouped_matmul(m(r(3, 4, 8)),
                                                   m(r(3, 6, 8))),
        "grouped_swiglu": lambda m: grouped_swiglu(
            m(r(3, 4, 8).bfloat16()), m(r(3, 6, 8).bfloat16())),
        "gather_pages": lambda m: kv.gather_pages(m(r(5, 4, 2, 8)), m(i)),
        "scatter_pages": lambda m: kv.scatter_pages(m(r(5, 4, 2, 8)), m(i),
                                                    m(r(2, 4, 2, 8))),
        "gather_pages_rows": lambda m: kv.gather_pages_rows(
            m(r(2, 3, 5, 16)), m(i)),
        "scatter_pages_rows": lambda m: kv.scatter_pages_rows(
            m(r(2, 3, 5, 16)), m(i), m(r(2, 3, 2, 16))),
        "pack_peer_chunks": lambda m: er.pack_peer_chunks(m(r(3, 8, 4)), 2),
        "interleave_shards": lambda m: er.interleave_shards(
            m(r(2, 3, 4, 4))),
        "pack_width_chunks": lambda m: er.pack_width_chunks(m(r(3, 4, 8)),
                                                            2),
        "interleave_width_shards": lambda m: er.interleave_width_shards(
            m(r(2, 3, 4, 4))),
    }
    for op, fn in cases.items():
        dispatch.reset_counts()
        dispatch.reset_costs()
        plain = fn(lambda t: t)
        got = fn(lambda t: t.to("meta"))
        assert got.device.type == "meta", op
        assert got.shape == plain.shape and got.dtype == plain.dtype, op
        assert sum(dispatch.COUNTS.values()) == 0, op
        assert dispatch.COSTS[op]["calls"] == 1, op
        assert dispatch.COSTS[op]["bytes"] > 0, op
    with pytest.raises(ValueError, match="mixed"):
        grouped_matmul(r(3, 4, 8), r(3, 6, 8).to("meta"))


@pytest.mark.parametrize("with_counts", [False, True])
def test_meta_grouped_swiglu_tallies_its_work(with_counts):
    """On `meta` the fused w13 + SwiGLU stands in for #2 with its epilogue:
    2 E C 2I D operations (every row filled), bytes of x, w13, the I-wide
    output and the counts; fp32 goes the unfused way (#2's own tally)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.moe_gemm.ops import grouped_swiglu
    E, C, D, I = 6, 16, 64, 40
    bf = torch.bfloat16
    x = torch.empty(E, C, D, dtype=bf, device="meta")
    w13 = torch.empty(E, 2 * I, D, dtype=bf, device="meta")
    counts = torch.empty(E, dtype=torch.int32, device="meta") \
        if with_counts else None
    dispatch.reset_costs()
    dispatch.reset_counts()
    out = grouped_swiglu(x, w13, counts)
    assert out.device.type == "meta" and out.shape == (E, C, I)
    assert out.dtype == bf and sum(dispatch.COUNTS.values()) == 0
    want = 2 * (E * C * D + E * 2 * I * D + E * C * I) \
        + (4 * E if with_counts else 0)
    assert dispatch.COSTS == {"grouped_swiglu": {
        "calls": 1, "flops": float(2 * E * C * 2 * I * D),
        "bytes": float(want)}}
    dispatch.reset_costs()
    grouped_swiglu(x.float(), w13.float(), counts)
    assert set(dispatch.COSTS) == {"grouped_matmul"}
    assert dispatch.COSTS["grouped_matmul"]["flops"] == 2 * E * C * 2 * I * D
    dispatch.reset_costs()


def test_attention_worst_case_work():
    """The meta tally's attention work equals chip_smoke's count on inputs
    with every page live (kv_len = maxp * page, queries at the end)."""
    from repro_torch.kernels.paged_attention.ops import worst_case_work
    for Sq, maxp, page, w in [(1, 4, 4, 0), (6, 3, 4, 0), (5, 4, 4, 6),
                              (1, 8, 16, 32), (16, 2, 16, 0)]:
        G, B, H, K, dh = 2, 3, 4, 2, 8
        kv = maxp * page
        qo = kv - Sq
        flops, nbytes = 0, 2 * G * B * Sq * H * dh * 2 \
            + 4 * (G * B * maxp + 2 * G * B)
        for _ in range(G * B):
            lo = max(0, qo - w + 1) if w else 0
            nbytes += 2 * (min(kv, qo + Sq) - lo) * K * dh * 2
            for s in range(Sq):
                qp = qo + s
                n = min(kv, qp + 1) - (max(0, qp - w + 1) if w else 0)
                flops += 4 * H * dh * max(n, 0)
        assert worst_case_work(G, B, Sq, H, K, dh, maxp, page, w, 2, 2) == \
            (flops, nbytes)


@pytest.mark.parametrize("name", FAMILY_CFGS)
def test_rank_share_rule(repro_data, name):
    """Per-rank bytes of a global tree run through repro's GSPMD forward or
    train step: `rank_share` of every leaf of each family's packed tree, in
    every default layout, equals the shard count of repro's `param_specs`
    on the same tree (mesh SPEC_MESH; the decode packs' rule is held to
    repro's lowering in test_argument_bytes_against_repro)."""
    from repro_torch.core.layouts import pack_params
    from repro_torch.launch.dryrun import _paths, meta_params, rank_share
    cfg = _family_cfg(name)
    dp, G = SPEC_MESH
    layouts = ["tp", "ep"] + (["tpep"] if cfg.is_moe else [])
    for lo in layouts:
        ge = dp * G if lo == "tpep" else None
        tree = pack_params(cfg, meta_params(cfg), lo, G, expert_G=ge)
        got = {path: rank_share(path, lo, G, ge or G, gspmd=True)
               for path, _ in _paths(tree)}
        assert got == repro_data["specs"][f"{name}|{lo}"], lo


def test_collective_tally():
    """`ranks.counting` tallies each collective by repro's HLO name with
    its result bytes over all ranks; outside it nothing is recorded."""
    from repro_torch.distributed import ranks
    x = torch.ones(4, 8, 3)
    with ranks.counting() as t:
        ranks.psum(x)
        ranks.all_gather(x)
        ranks.all_gather(x, tiled=True)
        ranks.all_to_all(x)
        ranks.all_to_all_into(x.reshape(4, 4, 2, 3),
                              torch.empty(4, 4, 2, 3))
        ranks.psum_scatter(x)
    assert dict(t["counts"]) == {"all-reduce": 1, "all-gather": 2,
                                 "all-to-all": 2, "reduce-scatter": 1}
    assert dict(t["total_bytes"]) == {
        "all-reduce": 4 * 96, "all-gather": 4 * (4 * 96 + 4 * 96),
        "all-to-all": 4 * (96 + 96), "reduce-scatter": 4 * 24}
    assert t["rank_calls"]["all-gather"] == 8
    ranks.psum(x)
    assert t["counts"]["all-reduce"] == 1


def test_dryrun_cli(tmp_path):
    """`python -m repro_torch.launch.dryrun` as a user runs it writes one
    record a cell and keeps going past a skipped one."""
    from repro_torch.launch.dryrun import main
    recs = main(["--arch", "whisper-base", "--shape",
                 "decode_32k,long_500k", "--layout", "ep", "--world", "2",
                 "--out", str(tmp_path)])
    assert [r["status"] for r in recs] == ["ok", "skipped"]
    got = json.loads((tmp_path / "whisper-base__decode_32k__pod1__ep.json")
                     .read_text())
    assert got["status"] == "ok" and got["world"] == 2
    assert got["memory"]["argument_size_in_bytes"] > 0
    assert "compile_s" not in got
    skip = json.loads((tmp_path / "whisper-base__long_500k__pod1__ep.json")
                      .read_text())
    assert skip["reason"].startswith("full quadratic attention")


# Where the port's argument bytes and repro's memory analysis part, by
# design. repro's compiled step does not read these leaves, and XLA leaves
# an argument no op reads out of its memory analysis; the port holds them,
# and counts them:
UNREAD = {
    # the decoder's cross-attention K/V projections: the cross cache,
    # projected once at admission, stands in for them while decoding
    ("whisper-base", "decode"): {"0/decoder/xattn/wk", "0/decoder/xattn/wv"},
    # the positions vector: an SSM decode step has no position
    ("mamba2-780m", "decode"): {"6"},
}


def _repro_only(kind: str, n_args: int, traced: str) -> set:
    """The leaves repro has and the port does not: a serve step's sampling
    key (its last argument, which no greedy step reads) and the optimizer's
    step counter (an int32 on the device in repro, a host int in the
    port)."""
    if kind == "train":
        return {"1/step"}
    return {str(n_args)} if traced.startswith("serving.") else set()


@pytest.mark.parametrize("cell", LOWER_CELLS,
                         ids=["-".join(map(str, c[:4])) for c in LOWER_CELLS])
def test_argument_bytes_against_repro(repro_lowered, cell):
    """The per-rank argument bytes of the port's dry run against repro's
    compiled memory analysis on the same cell: every leaf's bytes equal the
    bytes one device holds under repro's sharding, the total equals repro's
    `argument_size_in_bytes` up to the leaves named in UNREAD and
    `_repro_only`, and the serve steps call the same kinds of collective
    (repro's HLO counts a layer loop's once, and its combiner merges some,
    so the counts themselves differ)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import MeshShape, lower
    name, lo, (dp, G), kind, S, B = cell
    rec = lower(_family_cfg(name), ShapeSpec("small", S, B, kind),
                MeshShape({"data": dp, "model": G}), lo, page=PAGE)
    assert rec["status"] == "ok"
    want = repro_lowered["|".join(map(str, [name, lo, dp, G, kind]))]
    leaves, got = want["leaves"], rec["memory"]["arguments"]
    n_args = len({p.split("/")[0] for p in got})
    only = set(leaves) - set(got)
    assert only == _repro_only(kind, n_args, rec["traced"]["step"])
    assert set(got) <= set(leaves)
    unread = {p for p in got if leaves[p] is None}
    assert unread == UNREAD.get((name, kind), set())
    for path, b in got.items():
        assert path in unread or b == leaves[path], (path, b, leaves[path])
    assert rec["memory"]["argument_size_in_bytes"] == \
        want["argument_size_in_bytes"] + sum(got[p] for p in unread) \
        - sum(leaves[p] or 0 for p in only)
    if rec["traced"]["step"].startswith("serving."):
        assert sorted(rec["hlo_collectives"]["counts"]) == \
            want["collectives"]
