"""The port's switch policy and cost model on the CPU.

The 17 tests of tests/test_policy.py against the port's copies
(`repro_torch.core.policy`, `core.cost_model`; the engine test on
tiny_moe), then the copies against repro itself: `decode_step_time` and
`calibrate_threshold` on a grid, `SwitchCoordinator` decisions on the same
observation streams, and a policy-driven engine on a `VirtualClock` over a
bursty trace that makes repro's switches and gives repro's greedy tokens.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.layouts import EP, TP, TPEP, get_layout
from repro_torch.core.policy import (CostModelScorer, HysteresisPolicy,
                                     PolicyConfig, SwitchCoordinator,
                                     SwitchPolicy, calibrate_threshold)

torch.set_num_threads(1)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _coord(active=TP, t_high=100, t_low=80, window=4, cooldown=5.0):
    cfg = get_config("qwen3-235b-a22b")
    clock = FakeClock()
    c = SwitchCoordinator(cfg, 8, PolicyConfig(t_high=t_high, t_low=t_low,
                                               window=window,
                                               cooldown_s=cooldown),
                          active=active, clock=clock)
    return c, clock


def test_tp_to_ep_immediate_on_burst():
    c, clock = _coord(active=TP)
    clock.t = 10.0
    assert not c.observe(50, 0, 10**9).switch
    d = c.observe(150, 0, 10**9)
    assert d.switch and d.target == EP


def test_ep_to_tp_requires_sustained_dip_and_window():
    c, clock = _coord(active=EP)
    clock.t = 10.0
    # single dip below t_low is not enough (window=4)
    for count in (200, 200, 10, 200):
        assert not c.observe(count, 0, 10**9).switch
    assert c.active == EP
    for count in (10, 10, 10, 10):
        c.observe(count, 0, 10**9)
        clock.t += 0.1
    assert c.active == TP           # sustained dip flipped it


def test_cooldown_bounds_switch_rate():
    c, clock = _coord(active=TP, cooldown=5.0)
    clock.t = 10.0
    assert c.observe(150, 0, 10**9).switch            # TP -> EP
    clock.t = 11.0
    for _ in range(8):
        assert not c.observe(1, 0, 10**9).switch      # cooldown holds
    clock.t = 20.0
    for _ in range(4):
        c.observe(1, 0, 10**9)
        clock.t += 0.1
    assert c.active == TP                             # switched back


def test_capacity_veto_cancels_ep_to_tp():
    """Paper §4.5: TP replicates KV heads -> halved capacity on Qwen3."""
    c, clock = _coord(active=EP, window=1)
    clock.t = 100.0
    cap_ep = 1000
    # paper: Qwen3's 4 KV heads on 8 ranks -> kv_rep=2, capacity halved
    assert c.tp_kv_capacity_tokens(cap_ep) == cap_ep // 2
    d = c.observe(5, live_tokens=900, ep_capacity_tokens=cap_ep)
    assert not d.switch and "capacity" in d.reason
    assert c.canceled == 1
    clock.t = 110.0
    d = c.observe(5, live_tokens=100, ep_capacity_tokens=cap_ep)
    assert d.switch and d.target == TP


def test_calibrated_threshold_in_paper_band():
    cfg = get_config("qwen3-235b-a22b")
    from repro_torch.core.cost_model import H200
    th = calibrate_threshold(cfg, 8, kv_len=2048, hw=H200)
    assert 128 < th <= 256, th          # paper: crossover in (128, 256]


# ---------------------------------------------------------------------------
# N-layout cost-model policy
# ---------------------------------------------------------------------------

def _coord3(active=TP, t_high=100, t_low=80, window=2, cooldown=5.0):
    cfg = get_config("qwen3-235b-a22b")
    clock = FakeClock()
    c = SwitchCoordinator(cfg, 8, PolicyConfig(t_high=t_high, t_low=t_low,
                                               window=window,
                                               cooldown_s=cooldown),
                          active=active, clock=clock,
                          layouts=(TP, EP, TPEP), chips=64)
    return c, clock


def test_three_layouts_use_cost_model_scorer():
    c, _ = _coord3()
    assert isinstance(c.policy_impl, SwitchPolicy)
    assert isinstance(c.policy_impl, HysteresisPolicy)
    scorer = c.policy_impl.scorer
    assert isinstance(scorer, CostModelScorer)
    # every registered layout is ranked along the concurrency order
    assert set(scorer.ordered) == {TP, EP, TPEP}
    assert scorer.ordered[0] is TP      # TP wins the low-concurrency end


def test_cost_policy_burst_moves_up_and_dip_moves_down():
    c, clock = _coord3(active=TP)
    clock.t = 10.0
    assert not c.observe(50, 0, 10**9).switch          # inside the band
    d = c.observe(4096, 0, 10**9)                      # burst above T_h
    assert d.switch and get_layout(d.target) is not TP
    # sustained dip below T_l walks back down to TP
    clock.t = 100.0
    for _ in range(4):
        d = c.observe(1, 0, 10**9)
        clock.t += 0.1
    assert c.active is TP, c.active


def test_cost_policy_respects_kv_feasibility():
    """Pooled-view candidates (tp/tpep, kv_rep=2 on qwen3) are infeasible
    when the live token set exceeds their halved capacity: the proposal is
    vetoed and counted, exactly like the 2-layout capacity veto."""
    c, clock = _coord3(active=EP, window=1)
    clock.t = 100.0
    cap_ep = 1000
    d = c.observe(5, live_tokens=900, ep_capacity_tokens=cap_ep)
    assert not d.switch
    assert c.active is EP and c.canceled == 0          # scorer filtered them
    clock.t = 110.0
    d = c.observe(5, live_tokens=100, ep_capacity_tokens=cap_ep)
    assert d.switch and get_layout(d.target) is not EP


def test_static_config_disables_any_scorer():
    """The huge-T_h / negative-T_l convention must stay a hard off switch
    even when the cost-model scorer is active (benchmarks rely on it)."""
    c, clock = _coord3(t_high=10**9, t_low=-1, window=1, cooldown=10**9)
    clock.t = 10.0
    for count in (1, 500, 10**6):
        assert not c.observe(count, 0, 10**9).switch


# ---------------------------------------------------------------------------
# Engine wiring: the policy clock is the engine's VIRTUAL clock
# ---------------------------------------------------------------------------

def test_engine_policy_runs_on_virtual_clock():
    """Regression: cooldown_s used wall-clock time.monotonic while the
    engine ran on a scaled virtual clock (EngineConfig.time_scale), so
    cooldowns were wrong whenever time_scale != 1. The coordinator must use
    engine.now — virtual seconds — as its clock. (repro runs this on
    tiny_dense; the port serves the moe family, so tiny_moe.)"""
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.kvcache import CacheConfig
    from tests._torch_common import port_tiny_moe
    eng = MoebiusEngine(
        port_tiny_moe(), (1, 1),
        CacheConfig(page_size=4, pages_ep=16, max_pages_per_req=8),
        ecfg=EngineConfig(policy=PolicyConfig(t_high=10**9, t_low=-1,
                                              cooldown_s=5.0),
                          time_scale=60.0), device="cpu")
    assert eng.coord.clock == eng.now
    # pin a switch at virtual-now; wall time stays ~0 for the whole test,
    # so under the old wall-clock policy the cooldown could never elapse
    eng.coord._last_switch = eng.now()
    assert eng.coord.observe(0, 0, 10**9).reason == "cooldown"
    # advance the VIRTUAL clock by 12s (0.2 wall-s * time_scale=60)
    eng._t0 -= 0.2
    assert eng.coord.observe(0, 0, 10**9).reason != "cooldown"


def test_attainment_gate_breaks_hysteresis_hold():
    """QoS gate (DESIGN.md §11): an interactive-class SLO violation fires
    the scorer's best layout on the INSTANTANEOUS count — no windowed-mean
    wait — but only when interactive work is actually in flight."""
    inter = (("interactive", 2, 0),)
    # control: a single dip below t_low without the gate holds (window=4)
    c, clock = _coord(active=EP)
    clock.t = 10.0
    assert not c.observe(10, 0, 10**9).switch
    # same dip with a violated floor (0.9 default) switches down NOW
    c, clock = _coord(active=EP)
    clock.t = 10.0
    d = c.observe(10, 0, 10**9, attainment=0.5, per_class=inter)
    assert d.switch and d.target == TP and "attainment" in d.reason
    # no interactive in flight -> the gate stays quiet
    c, clock = _coord(active=EP)
    clock.t = 10.0
    assert not c.observe(10, 0, 10**9, attainment=0.5,
                         per_class=(("batch", 3, 0),)).switch
    # healthy attainment -> the normal hold still applies
    c, clock = _coord(active=EP)
    clock.t = 10.0
    assert not c.observe(10, 0, 10**9, attainment=1.0,
                         per_class=inter).switch


def test_attainment_gate_respects_static_config():
    """A static config (t_low < 0) is a hard off switch, attainment gate
    included — benchmark baselines rely on static engines never moving."""
    c, clock = _coord(active=EP, t_high=10**9, t_low=-1)
    clock.t = 10.0
    for _ in range(6):
        d = c.observe(10, 0, 10**9, attainment=0.0,
                      per_class=(("interactive", 5, 0),))
        assert not d.switch
        clock.t += 1.0
    assert c.active == EP


def test_observe_queues_threads_attainment_and_classes():
    """The coordinator's snapshot entrypoint forwards the per-class depths
    and the attainment signal into the PolicyObservation the gate reads."""
    from repro_torch.serving.scheduler import QueueSnapshot
    c, clock = _coord(active=EP)
    clock.t = 10.0
    q = QueueSnapshot(in_flight=10, live_tokens=0, pending=0, waiting=0,
                      prefilling=0, running=10,
                      per_class=(("interactive", 10, 0),))
    d = c.observe_queues(q, 10**9, attainment=0.2)
    assert d.switch and d.target == TP


# ---------------------------------------------------------------------------
# abort backoff (DESIGN.md §12)
# ---------------------------------------------------------------------------

def test_abort_backoff_grows_effective_cooldown():
    """Every aborted switch multiplies the effective cooldown by
    backoff_base, capped at backoff_max; observe() honors it."""
    c, clock = _coord(active=TP, cooldown=5.0)
    assert c.effective_cooldown_s == 5.0
    clock.t = 10.0
    c.switch_aborted(TP)
    assert c.aborted == 1 and c.active == TP
    assert c.effective_cooldown_s == 10.0          # base 2.0
    c.switch_aborted(TP)
    assert c.effective_cooldown_s == 20.0
    # cooldown re-armed at the abort: a burst inside the backed-off
    # window holds even past the base cooldown
    clock.t = 10.0 + 12.0                          # > 5 s, < 20 s
    assert not c.observe(150, 0, 10**9).switch
    clock.t = 10.0 + 21.0
    assert c.observe(150, 0, 10**9).switch


def test_abort_backoff_caps_and_resets_on_completion():
    c, clock = _coord(active=TP, cooldown=1.0)
    for _ in range(20):
        c.switch_aborted(TP)
    assert c.backoff_mult == c.policy.backoff_max  # capped, not 2**20
    c.switch_completed(EP)
    assert c.backoff_mult == 1.0 and c.active == EP


def test_abort_backoff_disabled_by_base_le_1():
    cfg = get_config("qwen3-235b-a22b")
    c = SwitchCoordinator(cfg, 8,
                          PolicyConfig(backoff_base=1.0, cooldown_s=5.0),
                          active=TP, clock=FakeClock())
    c.switch_aborted(TP)
    assert c.effective_cooldown_s == 5.0


def test_mid_switch_reversal_follows_scorer():
    """The regret check: reversal iff the scorer prefers the SOURCE at the
    instantaneous count; static configs never reverse."""
    from repro_torch.serving.scheduler import QueueSnapshot

    def q(n):
        return QueueSnapshot(in_flight=n, live_tokens=0, pending=0,
                             waiting=0, prefilling=0, running=n)

    c, _ = _coord(active=TP, t_high=100, t_low=80)
    # migrating tp -> ep while load collapsed below t_low: reverse
    assert c.mid_switch_reversal(TP, EP, q(10), 10**9)
    # load still above t_high: the target is right, keep migrating
    assert not c.mid_switch_reversal(TP, EP, q(150), 10**9)
    # dead-band: no verdict, no reversal
    assert not c.mid_switch_reversal(TP, EP, q(90), 10**9)
    # static config: never
    s, _ = _coord(active=TP, t_high=10**9, t_low=-1)
    assert not s.mid_switch_reversal(TP, EP, q(1), 10**9)


# ---------------------------------------------------------------------------
# the port's copies against repro
# ---------------------------------------------------------------------------

def _both_configs(arch):
    from repro.configs import get_config as j_get_config
    return j_get_config(arch), get_config(arch)


@pytest.mark.parametrize("hw_name", ["TPU_V5E", "H200"])
@pytest.mark.parametrize("arch", ["qwen3-235b-a22b", "mixtral-8x7b",
                                  "qwen2-moe-a2.7b"])
def test_cost_model_matches_repro(arch, hw_name):
    from repro.core import cost_model as jcm
    from repro.core import policy as jpol
    from repro_torch.core import cost_model as cm
    jcfg, cfg = _both_configs(arch)
    jhw, hw = getattr(jcm, hw_name), getattr(cm, hw_name)
    assert jhw == jcm.HWSpec(**{f: getattr(hw, f) for f in
                                hw.__dataclass_fields__})
    for layout in ("tp", "ep", "tpep"):
        for G in (2, 4, 8):
            for B in (1, 7, 64, 512):
                for kv in (128, 4096):
                    assert (cm.decode_step_time(cfg, layout, B, kv, hw, G)
                            == jcm.decode_step_time(jcfg, layout, B, kv, jhw,
                                                    G)), (layout, G, B, kv)
    for G in (2, 8):
        for kv in (512, 2048, 4096):
            assert (calibrate_threshold(cfg, G, kv, hw)
                    == jpol.calibrate_threshold(jcfg, G, kv, jhw))


def test_h100_spec_is_the_data_sheet():
    from repro_torch.core.cost_model import H100, decode_step_time
    assert (H100.peak_flops, H100.hbm_bw, H100.link_bw) == (989e12, 3.35e12,
                                                             450e9)
    cfg = get_config("qwen3-235b-a22b")
    # the port's defaults are the H100's
    assert (decode_step_time(cfg, "tp", 64, 2048)
            == decode_step_time(cfg, "tp", 64, 2048, H100))
    assert calibrate_threshold(cfg, 8) == calibrate_threshold(cfg, 8,
                                                              hw=H100)


@pytest.mark.parametrize("layouts", [("tp", "ep"), ("tp", "ep", "tpep")])
def test_coordinator_decisions_match_repro(layouts):
    """Random observation streams with the clock stepping through the
    cooldowns: the port's coordinator decides as repro's, and the same
    aborts feed both. With three layouts the cost-model scorer decides;
    it is given repro's default hardware, which the port's default (the
    H100) replaces."""
    from repro.core import cost_model as jcm
    from repro.core import policy as jpol
    from repro_torch.core import cost_model as cm
    from repro_torch.core import policy as pol
    jcfg, cfg = _both_configs("qwen3-235b-a22b")
    rng = np.random.default_rng(5)
    for trial in range(4):
        pc = dict(t_high=int(rng.integers(20, 200)),
                  window=int(rng.integers(1, 6)),
                  cooldown_s=float(rng.uniform(0.5, 3.0)))
        pc["t_low"] = int(pc["t_high"] * 0.8)
        clocks = [[0.0], [0.0]]
        impls = [None, None]
        if len(layouts) > 2:
            impls = [m.HysteresisPolicy(m.CostModelScorer(
                c, 8, layouts, hw=hw.TPU_V5E, chips=16,
                quiet_count=pc["t_low"]), m.PolicyConfig(**pc))
                for m, c, hw in ((jpol, jcfg, jcm), (pol, cfg, cm))]
        coords = [jpol.SwitchCoordinator(
            jcfg, 8, jpol.PolicyConfig(**pc), active="tp",
            clock=lambda: clocks[0][0], layouts=layouts, chips=16,
            policy_impl=impls[0]),
            SwitchCoordinator(cfg, 8, PolicyConfig(**pc), active="tp",
                              clock=lambda: clocks[1][0], layouts=layouts,
                              chips=16, policy_impl=impls[1])]
        for t in range(120):
            n = int(rng.integers(0, 2 * pc["t_high"]))
            live = int(rng.integers(0, 4000))
            cap = int(rng.integers(1000, 8000))
            dec = []
            for c, clk in zip(coords, clocks):
                clk[0] = 0.25 * t
                d = c.observe(n, live, cap)
                dec.append((d.switch, str(d.target), d.reason))
            assert dec[0] == dec[1], (trial, t, dec)
            if dec[0][0] and t % 7 == 0:
                for c in coords:
                    c.switch_aborted("tp" if dec[0][1] == "ep" else "ep")
        assert coords[0].canceled == coords[1].canceled
        assert [(a, str(b), str(c), r) for a, b, c, r in coords[0].switches] \
            == [(a, str(b), str(c), r) for a, b, c, r in coords[1].switches]


def _bursty(cls):
    """A short bursty trace (serving/workloads.py) on tiny_moe's vocab."""
    from repro_torch.serving.workloads import BurstySpec, bursty_trace
    spec = BurstySpec(duration_s=1.5, burst_windows=((0.1, 0.45),),
                      burst_rates=(50.0,), quiet_rate=3.0,
                      prompt_range=(4, 12), output_range=(6, 14))
    return [cls(rid=r.rid, prompt=[5 + t % 240 for t in r.prompt],
                max_new_tokens=r.max_new_tokens, arrival_s=r.arrival_s)
            for r in bursty_trace(spec, seed=0)]


BURST_POLICY = dict(t_high=4, t_low=2, window=3, cooldown_s=0.05)
BURST_CC = dict(page_size=4, pages_ep=96, max_pages_per_req=16)


@pytest.mark.parametrize("chunk", [0, 1])
def test_policy_engine_matches_repro(tiny_moe, chunk):
    """Both engines on a VirtualClock (dispatch_dt per dispatch, idle
    skip) over the same bursty trace with the same policy: the port
    switches where repro switches (direction and virtual time), both ways,
    and gives repro's greedy tokens (repro with prefix_cache=False and
    qos=False; ROADMAP C3 — the tiny f32 model's margins are clear here,
    so the tokens are compared whole)."""
    from repro.core.policy import PolicyConfig as JPolicyConfig
    from repro.launch.mesh import make_mesh
    from repro.serving.engine import EngineConfig as JEngineConfig
    from repro.serving.engine import MoebiusEngine as JMoebiusEngine
    from repro.serving.frontend import VirtualClock as JVirtualClock
    from repro.serving.kvcache import CacheConfig as JCacheConfig
    from repro.serving.request import Request as JRequest
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.frontend import VirtualClock
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.request import Request
    from tests._torch_common import jax_params, port_tiny_moe
    jp, tp = jax_params(tiny_moe)
    common = dict(start_layout="tp", ladder=(4, 8, 16), prefill_chunk=8,
                  dispatch_dt=0.01, chunk_layers=chunk)
    jeng = JMoebiusEngine(
        tiny_moe, make_mesh((1, 1), ("data", "model")),
        JCacheConfig(**BURST_CC), params_global=jp,
        ecfg=JEngineConfig(policy=JPolicyConfig(**BURST_POLICY),
                           clock=JVirtualClock(), prefix_cache=False,
                           qos=False, **common))
    eng = MoebiusEngine(port_tiny_moe(), (1, 1), CacheConfig(**BURST_CC),
                        params_global=tp,
                        ecfg=EngineConfig(policy=PolicyConfig(**BURST_POLICY),
                                          clock=VirtualClock(), **common),
                        device="cpu")
    outs, switches = [], []
    for e, cls in ((jeng, JRequest), (eng, Request)):
        reqs = _bursty(cls)
        for r in reqs:
            e.submit(r)
        e.run(max_steps=3000)
        assert len(e.finished) == len(reqs)
        outs.append({r.rid: list(r.output) for r in e.finished})
        switches.append([(r.direction, round(r.t, 9))
                         for r in e.switch_records])
    dirs = [d for d, _ in switches[1]]
    assert "tp_to_ep" in dirs and "ep_to_tp" in dirs, switches
    assert switches[0] == switches[1]
    assert outs[0] == outs[1]


def test_mid_switch_reversal_aborts_chunked_switch():
    """A chunked switch the policy regrets at a chunk boundary (the load
    is below T_low, so the scorer prefers the source) is abandoned: the
    source layout stays live, the abort is recorded with its backoff, and
    the outputs are the never-switched run's."""
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import EngineConfig, MoebiusEngine
    from repro_torch.serving.kvcache import CacheConfig
    from repro_torch.serving.request import Request
    from tests._torch_common import port_tiny_moe
    cfg = port_tiny_moe()
    params = init_params(cfg, 0, device="cpu")

    def run(switch):
        eng = MoebiusEngine(
            cfg, (1, 2), CacheConfig(page_size=4, pages_ep=32,
                                     max_pages_per_req=16),
            params_global=params,
            ecfg=EngineConfig(ladder=(4, 8), prefill_chunk=8,
                              chunk_layers=1, decode_steps=4,
                              policy=PolicyConfig(t_high=100, t_low=50,
                                                  window=1, cooldown_s=0.0)),
            device="cpu")
        rng = np.random.default_rng(2)
        for i in range(3):
            eng.submit(Request(rid=i, prompt=list(rng.integers(5, 200, 6)),
                               max_new_tokens=10, arrival_s=0.0))
        for _ in range(3):
            eng.step()
        if switch:
            assert eng.execute_switch("ep") is False
            assert eng.active == "tp" and not eng.switch_in_progress()
            assert len(eng.metrics.switch_abort_events) == 1
            assert not eng.switch_records
            assert eng.coord.aborted == 1 and eng.coord.backoff_mult == 2.0
        eng.run()
        return {r.rid: r.output for r in eng.finished}

    assert run(True) == run(False)
