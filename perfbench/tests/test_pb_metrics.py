"""The metric readers on synthetic records: what each end-to-end metric
measures, and that a stalled window cannot hide in the tail."""
import importlib.util
from dataclasses import dataclass, field
from pathlib import Path

import pytest

from arch import gqa_moe
from harness.serve import Rec, Span, Window

BENCH = Path(__file__).resolve().parents[1]


def reader(name):
    stem = name.split(".")[0]
    spec = importlib.util.spec_from_file_location(
        f"t_{stem}", BENCH / "metrics" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Req:
    prompt: list
    output: list = field(default_factory=list)


@dataclass
class Run:
    win: object
    setup_s: float = 1.0
    model: dict = None
    trace: dict = None
    cell: object = None
    arch: object = None


def window(recs, t1=10.0):
    w = Window(t0=0.0, t1=t1, seconds=t1)
    w.recs = recs
    return w


def served(due, first, done, n):
    return Rec(req=Req([1] * 8, [5] * n), due=due, submitted=due,
               left_wait=due + 0.01, first=first, done=done)


def test_ttft_counts_requests_without_a_first_token():
    recs = [served(i * 0.1, i * 0.1 + 0.2, i * 0.1 + 1.0, 10)
            for i in range(40)]
    base = reader("ttft_p95_s")(Run(window(recs)))
    assert base == pytest.approx(0.2)
    # a stall: the last 10 requests due get no first token by t1 = 10
    stalled = recs[:30] + [Rec(req=Req([1] * 8), due=5.0 + i * 0.1,
                               submitted=5.0 + i * 0.1) for i in range(10)]
    s = reader("ttft_p95_s")(Run(window(stalled)))
    assert s > 4.0                       # they count at what they waited
    q = reader("queue_wait_p95_s")(Run(window(stalled)))
    assert q > 4.0


def test_tpot_and_gen_tok_s():
    recs = [served(0.0, 1.0, 1.0 + 0.05 * 9, 10) for _ in range(20)]
    recs.append(served(0.0, 1.0, 1.0, 1))             # one token: no TPOT
    w = window(recs)
    w.tokens = sum(len(r.req.output) for r in recs)
    assert reader("tpot_p95_ms")(Run(w)) == pytest.approx(50.0)
    assert reader("gen_tok_s")(Run(w)) == pytest.approx(201 / 10.0)


def test_step_span_readers():
    w = window([])
    d = dict(prefill_tokens=0, decode_substeps=8)
    w.spans = [Span(0.0, 0.04, d, False),
               Span(0.04, 0.10, dict(prefill_tokens=256, decode_substeps=1),
                    False),
               Span(0.10, 0.20, dict(prefill_tokens=0, decode_substeps=8),
                    True)]
    assert reader("decode_ms_per_step")(Run(w)) == pytest.approx(5.0)
    assert reader("prefill_tok_s")(Run(w)) == pytest.approx(256 / 0.06)
    assert reader("iter_ms")(Run(w)) == pytest.approx(10.0 * 1e3 / 3)


def test_trace_readers_and_nothing_to_read():
    red = {"window_s": 2.0, "busy_us": 1.5e6, "n_dev": 10, "tokens": 1000,
           "by_group_us": {"other": 3000.0, "gmm": 2000.0, "attn": 400.0},
           "attn_min_s": 200e-6, "attn_flops": 0.0}
    run = Run(window([]), trace=red,
              model={"d_model": 8, "num_heads": 2, "num_kv_heads": 1,
                     "head_dim": 4, "num_experts": 4, "top_k": 2,
                     "d_expert": 8, "num_layers": 1, "vocab_size": 16},
              arch=gqa_moe)
    assert reader("idle_share")(run) == pytest.approx(25.0)
    assert reader("other_dev_us_per_tok")(run) == pytest.approx(3.0)
    assert reader("gmm_dev_us_per_tok")(run) == pytest.approx(2.0)
    assert reader("attn_roofline")(run) == pytest.approx(50.0)
    assert 0 < reader("mfu")(run) < 1e-3
    empty = Run(window([]))
    for name in ("idle_share", "other_dev_us_per_tok", "gmm_dev_us_per_tok",
                 "attn_roofline", "mfu", "switch_pause_ms", "iter_ms"):
        assert reader(name)(empty) is None


def test_verdict_compares_what_the_limits_name():
    from harness.check import ratio, verdict
    read = {"mean_gap": 0.02, "tokens": 500}
    read["gap_ratio_same"] = ratio(read, {"mean_gap": 0.01})
    ok, checks = verdict(read, {"gap_ratio_same": 3.0})
    assert ok and set(checks) == {"gap_ratio_same", "tokens_compared"}
    assert not verdict(read, {"gap_ratio_same": 1.5})[0]
    assert not verdict(read, {"mean_gap": 0.01})[0]
    assert not verdict(dict(read, tokens=10), {"mean_gap": 0.05})[0]
    assert ratio(read, {"mean_gap": 0.0}) == float("inf")
    with pytest.raises(ValueError):
        verdict(read, {})


@pytest.mark.parametrize("name, group", [
    ("void (anonymous namespace)::paged_attn_split_kernel<128, 4>"
     "((anonymous namespace)::SplitParams)", "attn"),
    ("void (anonymous namespace)::gmm_wgmma_kernel<256>(CUtensorMap_st, "
     "CUtensorMap_st, int const*, __nv_bfloat16*)", "gmm"),
    ("(anonymous namespace)::gmm_kernel(float const*, float const*, "
     "int const*, float*, int)", "gmm"),
    ("void (anonymous namespace)::copy_kernel<uint4, true>(char*, int const*,"
     " char*, (anonymous namespace)::Geometry, unsigned int)", "kv_pack"),
    ("void (anonymous namespace)::permute_runs_kernel<uint4>(uint4 const*, "
     "uint4*, (anonymous namespace)::RunMap)", "reshard"),
    # PyTorch's own copies carry `copy_kernel` inside their names: they are
    # the MoE dispatch's gathers and casts, and belong to "other"
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::"
     "operator()() const::{lambda(c10::BFloat16)#1}>(int)", "other"),
    ("void at::native::vectorized_elementwise_kernel<8, at::native::"
     "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1},"
     " std::array<char*, 2ul> >(int)", "other"),
    ("void at::native::(anonymous namespace)::copy_kernel<int>(int)", "other"),
    ("nvjet_tst_384x32_64x4_2x1_v_bz_TNT", "other"),
])
def test_kernel_groups_take_the_ports_functions_by_whole_name(name, group):
    from harness.trace import kernel_group
    assert kernel_group(name) == group
