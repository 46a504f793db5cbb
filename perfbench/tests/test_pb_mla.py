"""The latent-attention architecture (`arch/mla_moe.py`, moonlight-16b-a3b)
against the port it drives: the leaf tree the harness draws is the tree
`init_params` builds, the active weights and the attention site count
what the configuration does, #1's MLA counters read that site's tally,
the drawn bias spread is the port's, the new cell loads with its kernels
under `attn`, `switch_kv_gbps` reads what the switches record, and a CPU
rehearsal of a tiny MLA cell passes the check."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from arch import mla_moe
from harness import serve, spec, trace

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MOONLIGHT = BENCH / "configs" / "moonlight-16b-a3b.json"
DATA = BENCH / "tests" / "data_mla" / "BENCHMARK.json"
SEED = 2**31 + 11


def _model(path):
    with open(path) as f:
        return json.load(f)["model"]


def _tree(t, path=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _tree(v, f"{path}.{k}" if path else k)
    else:
        yield path, (tuple(t.shape), t.dtype)


@pytest.mark.parametrize("path", [MOONLIGHT,
                                  BENCH / "tests" / "data_mla" / "configs"
                                  / "tiny-mla.json"])
def test_leaf_tree_is_the_ports_init_tree(path):
    """Paths, shapes and dtypes of the drawn tree == the port's
    `init_params` for the configuration (on `meta`)."""
    from repro_torch.models.registry import init_params
    m = _model(path)
    cfg = serve.model_config(m)
    port = dict(_tree(init_params(cfg, device="meta")))
    ours = {p: (tuple(s), dt) for p, s, _, dt in mla_moe.leaf_specs(m)}
    assert ours == port


def test_active_params_and_attention_site():
    m = _model(MOONLIGHT)
    assert mla_moe.active_matmul_params(m) == 2_579_103_744
    site, = mla_moe.attn_sites(m)
    assert site == {"layers": 27, "kv_bytes_per_pos": 1152,
                    "qo_bytes_per_tok": 34_816, "flops_per_key": 34_816,
                    "window": 0}


def test_cell_loads_with_the_mla_kernels_under_attn():
    cell = spec.load_cell("moonlight-16b.rollout")
    assert cell.arch is mla_moe and cell.chips == 1
    assert cell.kernel_groups["paged_mla_kernel"] == "attn"
    assert cell.kernel_groups["paged_mla_combine_kernel"] == "attn"
    assert cell.kernel_groups["paged_attn_split_kernel"] == "attn"
    names = {m["name"] for m in cell.per_layer}
    assert "switch_kv_gbps.rollout" in names and len(names) == 10
    assert [m["name"] for m in cell.end_to_end] == ["gen_tok_s", "setup_s"]
    assert cell.traffic["engine"]["ladder"] == [2, 8, 32]
    n = "(anonymous namespace)::paged_mla_kernel<576, 512>(SplitParams, "
    assert trace.kernel_group(f"void {n}double*)",
                              cell.kernel_groups) == "attn"


def _mla_counted(m: dict, G: int, H: int, kv, Sq: int) -> tuple:
    """The port's `mla.bytes` and `mla.flops` for one step of every layer:
    #1's latent path called once a layer on (G, B) rows of Sq queries at
    KV lengths `kv` (the plain path counts what the kernel counts)."""
    from repro_torch import tracing
    from repro_torch.kernels.paged_attention.ops import paged_mla
    C, dk = m["kv_lora_rank"], m["kv_lora_rank"] + m["qk_rope_head_dim"]
    page = 16
    B = kv.shape[1]
    maxp = -(-int(kv.max()) // page)
    pool = torch.zeros(G, G * B * maxp + 1, page, dk, dtype=torch.bfloat16)
    bt = (torch.arange(G * B * maxp).reshape(G, B, maxp) + 1).int()
    q = torch.zeros(G, B, Sq, H, dk, dtype=torch.bfloat16)
    tracing.enable()
    try:
        tracing.prepare("cpu")
        tracing.reset_device()
        for g in range(G):
            paged_mla(q[g], pool[g], bt[g], kv[g], q_offset=kv[g] - Sq,
                      v_dim=C, scale=1.0)
        got = tracing.read_device()
    finally:
        tracing.disable()
    L = m["num_layers"]
    return got["mla.bytes"] * L, got["mla.flops"] * L


def test_mla_counters_read_the_attention_tally():
    """At the cell's widths, the counters #1's latent path adds (`mla.bytes`,
    `mla.flops`) against the harness's tally of the same step over
    `attn_sites` (what `attn_roofline` divides by): equal in ep, a decode
    substep and a prefill chunk; in tp the FLOPs are equal and the bytes
    exceed the tally by the second rank's read of the replicated latent,
    the departure PERF.md names."""
    m = _model(MOONLIGHT)
    tally = serve._AttnTally(mla_moe.attn_sites(m))
    H, dk = m["num_heads"], m["kv_lora_rank"] + m["qk_rope_head_dim"]
    g = torch.Generator().manual_seed(30)
    P = torch.randint(40, 400, (32,), generator=g)
    o0 = torch.randint(1, 800, (32,), generator=g)

    def req(p, pp, out):
        return SimpleNamespace(prompt_len=int(p), prefill_pos=int(pp),
                               output=[0] * int(out), inflight=0)

    reqs = [req(p, p, o) for p, o in zip(P, o0)]
    before = serve._AttnTally.where(reqs)
    for r in reqs:
        r.output.append(0)                      # one decode substep
    want = tally.tally(before)
    kv = (P + o0).int()                         # the keys the query sees
    # ep: 16 rows a rank, every head; tp: all 32 rows on both ranks, half
    # the heads each
    assert _mla_counted(m, 2, H, kv.reshape(2, 16), 1) == want
    nbytes, flops = _mla_counted(m, 2, H // 2, torch.stack([kv, kv]), 1)
    assert flops == want[1]
    assert nbytes == want[0] + m["num_layers"] * int(kv.sum()) * dk * 2
    # a 64-token prefill chunk of one prompt, short of its end
    r = req(900, 300, 0)
    before = serve._AttnTally.where([r])
    r.prefill_pos = 364
    assert _mla_counted(m, 1, H, torch.tensor([[364]]).int(), 64) == \
        tally.tally(before)


def test_bias_spread_is_the_ports():
    """The harness draws the router's correction bias at the spread the
    port's `init_params` draws it at."""
    from repro_torch.models import moe
    assert mla_moe.ROUTER_BIAS_STD == moe.ROUTER_BIAS_STD


def _reader(name):
    s = importlib.util.spec_from_file_location(
        f"t_{name}", BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Rec:
    kv_s: float
    kv_bytes: int


@dataclasses.dataclass
class OldRec:
    kv_s: float


def test_switch_kv_gbps_reads_records():
    read = _reader("switch_kv_gbps")

    def run(recs):
        return SimpleNamespace(win=SimpleNamespace(switches=recs))
    assert read(run([Rec(0.5, 2 * 10**9), Rec(0.5, 10**9)])) == \
        pytest.approx(3.0)
    assert read(run([])) is None
    assert read(run([OldRec(0.5)])) is None       # a program without them
    assert read(run([Rec(0.0, 0)])) is None


def test_rehearsal_of_a_tiny_mla_cell():
    s = importlib.util.spec_from_file_location("pb_run_mla",
                                               BENCH / "run.py")
    mod = importlib.util.module_from_spec(s)
    sys.modules["pb_run_mla"] = mod
    s.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(["--workload", "tiny-mla.rollout", "--seed",
                         str(SEED), "--seconds", "8", "--trace", "0",
                         "--device", "cpu", "--bench-file",
                         str(DATA)]) == 0
    lines = out.getvalue().strip().splitlines()
    res, log = json.loads(lines[-1]), json.loads(lines[-2])
    assert res["correct"] is True, res["checks"]
    assert log["check"]["tokens"] >= 100
    assert log["engine"]["counters"]["decode_tokens"] > 0
    torch.set_num_threads(2)
