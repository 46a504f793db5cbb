"""The architecture seam (`arch/`): `gqa_moe` reads what the harness read
before the seam (the same weights, leaves, active weights and attention
tally), the tally is a count of what attention reads at any window, and
a module put in place of it reaches every user of the architecture."""
import hashlib
import json
import math
import random
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from arch import gqa_moe
from harness import serve, spec, trace, weights as wmod
from harness.work import PEAKS

BENCH = Path(__file__).resolve().parents[1]
TINY = BENCH / "tests" / "data" / "configs" / "tiny-moe.json"
BF, F32 = torch.bfloat16, torch.float32


def _model(path):
    with open(path) as f:
        return json.load(f)["model"]


def _leaves(arch, m, tree):
    for path, *_ in arch.leaf_specs(m):
        node = tree
        for k in path.split("."):
            node = node[k]
        yield path, node


# sha256 over (path, bytes) of every leaf in draw order, taken on the
# harness before the seam
@pytest.mark.parametrize("seed, digest", [
    (2**31 + 5,
     "d1da8ba24f419f8a43a1794f581a3aab31b6c272c3e729ca085d26f3ff42746f"),
    (12345,
     "6920dfc73200c33907a75b1ab73022dbbd9cadd1f52b6a151a83cf6e7d010db7"),
])
def test_tiny_weights_hash_as_before_the_seam(seed, digest):
    m = _model(TINY)
    tree = wmod.make_weights(spec.arch_module({}), m, seed, "cpu")
    h = hashlib.sha256()
    for path, t in _leaves(gqa_moe, m, tree):
        h.update(path.encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == digest


S4096, S2048 = 1 / math.sqrt(4096), 1 / math.sqrt(2048)
QWEN3 = [
    ("embed", (151936, 4096), S4096, BF),
    ("lm_head", (151936, 4096), S4096, BF),
    ("final_norm.scale", (4096,), None, BF),
    ("layers.attn_norm.scale", (4, 4096), None, BF),
    ("layers.mlp_norm.scale", (4, 4096), None, BF),
    ("layers.attn.wq", (4, 4096, 8192), S4096, BF),
    ("layers.attn.wk", (4, 4096, 512), S4096, BF),
    ("layers.attn.wv", (4, 4096, 512), S4096, BF),
    ("layers.attn.wo", (4, 8192, 4096), 0.011048543456039804, BF),
    ("layers.attn.q_norm", (4, 128), None, BF),
    ("layers.attn.k_norm", (4, 128), None, BF),
    ("layers.moe.router", (4, 4096, 128), S4096, F32),
    ("layers.moe.w13", (4, 128, 3072, 4096), S4096, BF),
    ("layers.moe.w2", (4, 128, 4096, 1536), 0.025515518153991442, BF)]
QWEN2 = [
    ("embed", (151936, 2048), S2048, BF),
    ("lm_head", (151936, 2048), S2048, BF),
    ("final_norm.scale", (2048,), None, BF),
    ("layers.attn_norm.scale", (24, 2048), None, BF),
    ("layers.mlp_norm.scale", (24, 2048), None, BF),
    ("layers.attn.wq", (24, 2048, 2048), S2048, BF),
    ("layers.attn.wk", (24, 2048, 2048), S2048, BF),
    ("layers.attn.wv", (24, 2048, 2048), S2048, BF),
    ("layers.attn.wo", (24, 2048, 2048), S2048, BF),
    ("layers.moe.router", (24, 2048, 60), S2048, F32),
    ("layers.moe.w13", (24, 60, 2816, 2048), S2048, BF),
    ("layers.moe.w2", (24, 60, 2048, 1408), 0.026650089544451302, BF),
    ("layers.moe.shared_wg", (24, 5632, 2048), S2048, BF),
    ("layers.moe.shared_wu", (24, 5632, 2048), S2048, BF),
    ("layers.moe.shared_w2", (24, 2048, 5632), 0.013325044772225651, BF),
    ("layers.moe.shared_gate", (24, 2048), S2048, BF)]


@pytest.mark.parametrize("config, leaves, active", [
    ("qwen3-235b-a22b.l4", QWEN3, 1_513_619_456),
    ("qwen2-moe-a2.7b", QWEN2, 2_377_760_768)])
def test_real_configs_read_as_before_the_seam(config, leaves, active):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    arch = spec.arch_module(cfg)
    assert arch is gqa_moe
    m = cfg["model"]
    assert arch.leaf_specs(m) == leaves
    assert arch.active_matmul_params(m) == active
    assert arch.engine_owned(m) == ["layers.moe.w13", "layers.moe.w2"]
    assert arch.KERNEL_GROUPS == {}


# --- the attention tally ------------------------------------------------------

def _req(P, pp, out, inflight=0):
    return SimpleNamespace(prompt_len=P, prefill_pos=pp,
                           output=[0] * (out - inflight), inflight=inflight)


def _brute(site, P, pp0, pp1, o0, o1):
    """K/V bytes and FLOPs of one request's step, by enumeration: a prefill
    chunk's queries at [pp0, pp1) read the union of their keys once;
    output token j comes from the query at P - 1 + j, and each such query
    outside the chunk (a decode substep) reads its own keys."""
    w = site["window"]

    def keys(p):
        return range(max(0, p - w + 1) if w else 0, p + 1)

    chunk = range(pp0, pp1)
    read = set().union(*(set(keys(p)) for p in chunk)) if chunk else set()
    pairs = sum(len(keys(p)) for p in chunk)
    dec = [P - 1 + j for j in range(o0, o1) if P - 1 + j not in chunk]
    dec_keys = sum(len(keys(p)) for p in dec)
    L = site["layers"]
    nbytes = L * (site["kv_bytes_per_pos"] * (len(read) + dec_keys)
                  + site["qo_bytes_per_tok"] * (len(chunk) + len(dec)))
    return nbytes, L * site["flops_per_key"] * (pairs + dec_keys)


def _steps(rng, n):
    """(P, pp0, pp1, o0, o1): prefill chunks, chunks that end the prompt
    (its last query yields output token 0, decode may follow), and decode
    runs."""
    out = []
    for _ in range(n):
        P = rng.randint(1, 300)
        kind = rng.choice(("chunk", "last", "decode"))
        if kind == "chunk" and P > 1:
            pp0 = rng.randint(0, P - 2)
            out.append((P, pp0, rng.randint(pp0 + 1, P - 1), 0, 0))
        elif kind == "last":
            pp0 = rng.randint(0, P - 1)
            out.append((P, pp0, P, 0, rng.randint(1, 9)))
        else:
            o0 = rng.randint(1, 200)
            out.append((P, P, P, o0, o0 + rng.randint(1, 16)))
    return out


SITE = {"layers": 3, "kv_bytes_per_pos": 1024, "qo_bytes_per_tok": 4096,
        "flops_per_key": 2048}


@pytest.mark.parametrize("window", [0, 1, 7, 64, 257])
def test_tally_is_the_count_of_pairs_and_positions(window):
    site = dict(SITE, window=window)
    tally = serve._AttnTally([site])
    for P, pp0, pp1, o0, o1 in _steps(random.Random(window), 400):
        before = [(_req(P, pp1, o1, inflight=min(1, o1)), pp0, o0)]
        assert tally.tally(before) == _brute(site, P, pp0, pp1, o0, o1)


def test_tally_unbounded_is_the_closed_form_of_before_the_seam():
    m = _model(TINY)
    L, H, K, dh, b = 2, 4, 2, 64, 4              # tiny-moe, float32
    kv_tok, qo_tok = L * 2 * K * dh * b, L * 2 * H * dh * b
    flop_key = L * 4 * H * dh
    tally = serve._AttnTally(gqa_moe.attn_sites(m))
    for P, pp0, pp1, o0, o1 in _steps(random.Random(3), 400):
        nbytes = flops = 0.0
        o = o0
        if pp1 > pp0:
            n = pp1 - pp0
            nbytes += pp1 * kv_tok + n * qo_tok
            flops += flop_key * (n * (pp0 + pp1 + 1) / 2)
            if pp1 >= P and pp0 < P:
                o += 1
        dec = o1 - o
        if dec > 0:
            keys = dec * (P + o) + dec * (dec - 1) / 2
            nbytes += keys * kv_tok + dec * qo_tok
            flops += flop_key * keys
        assert tally.tally([(_req(P, pp1, o1), pp0, o0)]) == (nbytes, flops)


def test_tally_sums_its_sites():
    a, b = dict(SITE, window=0), dict(SITE, layers=5, window=16)
    both = serve._AttnTally([a, b])
    for P, pp0, pp1, o0, o1 in _steps(random.Random(9), 100):
        before = [(_req(P, pp1, o1), pp0, o0)]
        ba, fa = serve._AttnTally([a]).tally(before)
        bb, fb = serve._AttnTally([b]).tally(before)
        assert both.tally(before) == (ba + bb, fa + fb)


# --- a module in place of gqa_moe reaches every user --------------------------

def _probe():
    mod = types.ModuleType("arch.probe")
    mod.KERNEL_GROUPS = {"latent_attn_kernel": "attn"}
    mod.leaf_specs = lambda m: [("a.x", (3, 4), 0.5, F32),
                                ("a.y", (4,), None, F32),
                                ("b", (2, 3, 4), 0.1, F32)]
    mod.engine_owned = lambda m: ["a.x"]
    mod.attn_sites = lambda m: [dict(SITE, layers=m["num_layers"],
                                     window=4)]
    mod.active_matmul_params = lambda m: 1000
    return mod


def _bench(tmp_path, arch):
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    cfg = {"model": {"num_layers": 2}, "reference": "moe_lm"}
    if arch:
        cfg["arch"] = arch
    (tmp_path / "configs" / "c.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "t.json").write_text(json.dumps({"loop": "x"}))
    bench = {"configs": [{"name": "c", "file": "configs/c.json"}],
             "workloads": [{"name": "c.t", "config": "c", "traffic": "t",
                            "chips": 1}],
             "end_to_end": [], "per_layer": []}
    (tmp_path / "B.json").write_text(json.dumps(bench))
    return spec.load_cell("c.t", tmp_path / "B.json")


def _reader(name):
    import importlib.util
    s = importlib.util.spec_from_file_location(
        f"t_arch_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def test_default_arch_is_gqa_moe(tmp_path):
    assert _bench(tmp_path, None).arch is gqa_moe


def test_a_probe_arch_reaches_every_user(tmp_path, monkeypatch):
    probe = _probe()
    monkeypatch.setitem(sys.modules, "arch.probe", probe)
    cell = _bench(tmp_path, "probe")
    assert cell.arch is probe
    m = cell.config["model"]

    w = wmod.make_weights(cell.arch, m, 7, "cpu")       # the weights
    assert w["a"]["x"].shape == (3, 4) and w["b"].shape == (2, 3, 4)
    assert abs(float(w["a"]["y"].mean()) - 1.0) < 0.3  # a norm scale
    wmod.drop(w, cell.arch.engine_owned(m))             # the dropped leaves
    assert set(w["a"]) == {"y"} and "b" in w

    tally = serve._AttnTally(cell.arch.attn_sites(m))   # the tally
    got = tally.tally([(_req(10, 10, 6), 10, 3)])
    keys = 3 * 4                    # three substeps, each at the window
    assert got == (2 * (1024 * keys + 4096 * 3), 2 * 2048 * keys)

    table = cell.kernel_groups                          # kernel groups
    assert table == {**trace.GROUPS, "latent_attn_kernel": "attn"}
    ev = [SimpleNamespace(
        name="void (anonymous namespace)::latent_attn_kernel<576>(P)",
        device_type=torch.autograd.DeviceType.CUDA,
        time_range=SimpleNamespace(start=0.0, end=40.0))]
    sl = serve.Slice(t0=0.0, t1=1.0, prof=SimpleNamespace(events=lambda: ev),
                     d={"prefill_tokens": 0, "decode_tokens": 50},
                     attn_flops=1e9)
    red = trace.reduce_slices([sl], table)
    assert red["by_group_us"] == {"attn": 40.0}
    assert trace.kernel_group(ev[0].name) == "other"    # not in the base

    run = SimpleNamespace(trace=red, model=m, arch=cell.arch)   # mfu
    want = 100.0 * (2.0 * 1000 * 50 + 1e9) / PEAKS["bf16_flops_per_s"]
    assert _reader("mfu")(run) == pytest.approx(want, rel=1e-12)


def test_a_kernel_group_clashing_with_the_base_table_raises(
        tmp_path, monkeypatch):
    assert trace.groups({"gmm_kernel": "gmm"})["gmm_kernel"] == "gmm"
    with pytest.raises(ValueError, match="gmm_kernel"):
        trace.groups({"gmm_kernel": "attn"})
    probe = _probe()                        # and the cell does not load
    probe.KERNEL_GROUPS = {"gmm_kernel": "attn"}
    monkeypatch.setitem(sys.modules, "arch.probe", probe)
    with pytest.raises(ValueError, match="gmm_kernel"):
        _bench(tmp_path, "probe")


def test_model_config_takes_lists_as_tuples(monkeypatch):
    from repro_torch.models import common
    cfg = serve.model_config(_model(TINY))
    assert isinstance(cfg, common.ModelConfig) and hash(cfg)
    monkeypatch.setattr(common, "ModelConfig", lambda **kw: kw)
    kw = serve.model_config({"dtype": "float32", "layer_types": [0, 1, 0],
                             "n": 3})
    assert kw["layer_types"] == (0, 1, 0) and kw["n"] == 3
    assert hash(kw["layer_types"]) and kw["param_dtype"] is F32
