"""Resident runtimes at fixed addresses, on the CPU (tiny_moe, f32).

On a card the decode kinds are CUDA graphs (tests/test_torch_cuda.py holds
them there); on the CPU the same `ResidentRuntime` keeps the plain
callables, so what these tests check carries over: warmup builds every
(layout, bank, rung, kind) entry and nothing is built while serving and
switching; the static-capacity decode dispatch gives the trimmed one's
tokens; a monolithic switch writes the expert store and the KV buffer in
place, with the bytes the out-of-place movers give; a chunked switch ends
on the second bank that warmup allocated.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.layouts import EP, TP
from repro_torch.core.policy import PolicyConfig
from repro_torch.core.residency import ResidentRuntime
from repro_torch.models import moe
from repro_torch.serving import steps
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.kvcache import CacheConfig
from repro_torch.serving.request import Request
from tests._torch_common import jax_params, port_tiny_moe

torch.set_num_threads(1)
STATIC = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
CC = dict(page_size=4, pages_ep=32, max_pages_per_req=16)


@pytest.fixture(scope="module")
def setup(tiny_moe):
    _, tp = jax_params(tiny_moe)
    return port_tiny_moe(), tp


def _reqs(n=6):
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=list(rng.integers(5, 200, int(rng.integers(
        3, 10)))), max_new_tokens=int(rng.integers(4, 12)), arrival_s=0.0)
        for i in range(n)]


def _engine(cfg, tp, **kw):
    kw.setdefault("ladder", (4, 8))
    return MoebiusEngine(cfg, (1, 2), CacheConfig(**CC), params_global=tp,
                         ecfg=EngineConfig(prefill_chunk=8, policy=STATIC,
                                           **kw), device="cpu")


def _serve(eng, switch_at=(), modes=()):
    for r in _reqs():
        eng.submit(r)
    i = k = 0
    while eng.sched.has_work():
        if i in switch_at:
            eng.ecfg.chunk_layers = modes[k]
            k += 1
            eng.execute_switch("ep" if eng.active == "tp" else "tp")
        eng.step()
        i += 1
        assert i < 500
    eng.run()
    return {r.rid: r.output for r in eng.finished}


@pytest.mark.parametrize("N", [1, 4])
def test_no_build_after_warmup_through_round_trip(setup, N):
    """tp -> ep -> tp, monolithic then chunked: warmup built every entry,
    serving and both switches build none, and the tokens are the
    never-switched run's."""
    cfg, tp = setup
    base = _serve(_engine(cfg, tp, decode_steps=N))
    eng = _engine(cfg, tp, decode_steps=N, chunk_layers=1)
    eng.warmup()
    rt = eng.ex.rt
    kinds = 2 if N > 1 else 1
    assert eng.ex.banks == 2
    assert len(rt.executables) == 2 * 2 * 2 * kinds   # bank layout rung
    assert rt.warm and rt.late_builds == 0
    out = _serve(eng, switch_at=(3, 8), modes=(0, 1))
    assert [r.chunks for r in eng.switch_records] == [1, 2]
    assert out == base
    assert rt.late_builds == 0 and len(rt.executables) == 8 * kinds


def test_runtime_counts_late_builds():
    rt = ResidentRuntime(torch.device("cpu"))
    fn = rt.get_or_build(("tp", "mixed", 4, 1, 0), lambda: (lambda: 1))
    assert fn() == 1 and rt.late_builds == 0
    assert rt.get_or_build(("tp", "mixed", 4, 1, 0), None) is fn
    rt.mark_warm()
    rt.get_or_build(("ep", "mixed", 4, 1, 0), lambda: (lambda: 2))
    assert rt.late_builds == 1 and len(rt.build_times) == 2
    assert rt.pool_bytes() == 0 and not rt.replayed_launches()


@pytest.mark.parametrize("layout", ["tp", "ep"])
def test_static_capacity_dispatch_matches_trimmed(setup, layout,
                                                  monkeypatch):
    """Decode steps size the expert buffers at repro's static capacity (no
    host read); sizing them at the step's largest load gives the same
    MoE output and the same served tokens."""
    cfg, tp = setup
    eng = _engine(cfg, tp, start_layout=layout)
    p = {k: v[0] for k, v in eng.ex._assemble_pack(eng.active)["layers"]
         ["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 6, cfg.d_model), dtype=np.float32))
    lay = eng.active.expert_layout(cfg, 2)
    for trim in (True, False):
        y = (moe.moe_decode_tp(cfg, p, x, trim=trim) if layout == "tp"
             else moe.moe_decode_ep(cfg, p, x, lay, trim=trim))
        if trim:
            y_trim = y
    torch.testing.assert_close(y, y_trim, atol=1e-6, rtol=1e-6)
    static = _serve(eng)
    ffn = steps._ffn
    monkeypatch.setattr(steps, "_ffn", lambda *a, trim: ffn(*a, trim=True))
    assert _serve(_engine(cfg, tp, start_layout=layout)) == static


def _request_pages(eng, kv) -> dict:
    """rid -> the K/V pages of each live request in the active view."""
    view = eng.cc.view_shape(eng.cfg, eng.G, eng.active)
    out = {}
    for r in eng.sched.live():
        if not r.pages:
            continue
        pool = kv[r.data_group].view(eng.G, *view)
        idx = torch.tensor(r.pages)
        out[r.rid] = (pool[r.owner_rank][:, :, idx] if eng.active.kv_per_rank
                      else pool[:, :, :, idx])
    return out


@pytest.mark.parametrize("direct", [True, False])
@pytest.mark.parametrize("start", ["tp", "ep"])
def test_monolithic_switch_in_place(setup, start, direct):
    """The in-place switch keeps the store's and kv_flat's addresses and
    gives the bytes of the out-of-place movers: the whole store, and every
    live request's pages (page 0 and free pages excluded, C5)."""
    cfg, tp = setup
    target = EP if start == "tp" else TP
    engs = [_engine(cfg, tp, start_layout=start, direct_reshard=direct)
            for _ in range(2)]
    for eng in engs:
        for r in _reqs():
            eng.submit(r)
        for _ in range(4):
            eng.step()
    a, b = engs
    ptrs = ([v.data_ptr() for v in a.ex._experts.values()],
            a.kv_flat.data_ptr())
    a.execute_switch(target)
    assert ptrs == ([v.data_ptr() for v in a.ex._experts.values()],
                    a.kv_flat.data_ptr())
    experts, kv, *_ = b.ex.switcher.monolithic(
        b.active, target, b.sched.live(), b.ex._experts, b.kv_flat,
        cur_alloc=b.sched.alloc)
    assert kv.data_ptr() != b.kv_flat.data_ptr()
    for k in ("w13", "w2"):
        assert torch.equal(a.ex._experts[k], experts[k])
    got, want = _request_pages(a, a.kv_flat), _request_pages(a, kv)
    assert got and got.keys() == want.keys()
    for rid in got:
        assert torch.equal(got[rid], want[rid]), rid
    # and the switched engine serves on to the never-switched tokens
    ref = _serve(_engine(cfg, tp, start_layout=start))
    a.run()
    assert {r.rid: r.output for r in a.finished} == ref


def test_chunked_switch_lands_on_warmup_banks(setup):
    cfg, tp = setup
    eng = _engine(cfg, tp, chunk_layers=1)
    eng.warmup()
    ex = eng.ex
    banks = [([v.data_ptr() for v in ex._stores[b].values()],
              ex._kvs[b].data_ptr()) for b in range(2)]

    def where():
        return ([v.data_ptr() for v in ex._experts.values()],
                ex.kv_flat.data_ptr())

    assert where() == banks[0]
    for r in _reqs():
        eng.submit(r)
    for i, target in enumerate(("ep", "tp")):
        for _ in range(3):
            eng.step()
        eng.execute_switch(target)
        assert where() == banks[(i + 1) % 2]
    assert ex.rt.late_builds == 0
    assert ex.second_bank_bytes() == sum(
        v.numel() * v.element_size() for v in ex._stores[1].values()) + \
        ex._kvs[1].numel() * ex._kvs[1].element_size()
