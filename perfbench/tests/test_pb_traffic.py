"""The traffic generator: deterministic per seed, the same sizes and
arrival times in the same order for every seed, and the rates and
lengths the files ask for."""
import json
from pathlib import Path

import numpy as np
import pytest

from harness.traffic import ClosedRollout, draw_lengths, open_schedule

BENCH = Path(__file__).resolve().parents[1]


def traffic(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def key(items):
    return [(round(i.offset_s, 9), tuple(i.prompt), i.n_out) for i in items]


@pytest.mark.parametrize("cycle", [True, False])
def test_open_loop_is_deterministic_and_seed_draws_only_tokens(cycle):
    t = dict(traffic("chat-bursty"), rate_per_s=5.0)
    if not cycle:
        t.pop("cycle")
    a = open_schedule(t, 2**31 + 11, 151936, 60.0)
    b = open_schedule(t, 2**31 + 11, 151936, 60.0)
    c = open_schedule(t, 2**31 + 12, 151936, 60.0)
    assert key(a) == key(b)
    assert key(a) != key(c)
    # the same arrivals and lengths, in the same order; other tokens
    assert [(x.offset_s, len(x.prompt), x.n_out) for x in a] == \
        [(x.offset_s, len(x.prompt), x.n_out) for x in c]
    assert [x.prompt for x in a] != [x.prompt for x in c]
    assert all(0 <= x.offset_s < 60.0 for x in a)
    assert [x.offset_s for x in a] == sorted(x.offset_s for x in a)


def test_open_loop_rates_follow_the_cycle():
    t = dict(traffic("chat-bursty"), rate_per_s=5.0)
    items = open_schedule(t, 7, 151936, 2000.0)
    ts = np.array([i.offset_s for i in items])
    assert abs(len(ts) / 2000.0 - 5.0) < 0.3            # the mean rate
    phase = ts % 20.0
    burst = (phase < 8.0).sum() / (100 * 8.0)            # 100 cycles
    quiet = (phase >= 8.0).sum() / (100 * 12.0)
    assert abs(burst - 10.0) < 0.5 and abs(quiet - 5.0 / 3) < 0.2
    t.pop("cycle")
    steady = open_schedule(t, 7, 151936, 2000.0)
    gaps = np.diff([i.offset_s for i in steady])
    assert abs(gaps.mean() - 0.2) < 0.02                 # Poisson, 5/s
    assert abs(np.std(gaps) / gaps.mean() - 1.0) < 0.1   # exponential gaps


def test_chat_lengths():
    t = traffic("chat-bursty")
    rng = np.random.default_rng(0)
    p = draw_lengths(rng, t["prompt"], 20000)
    o = draw_lengths(rng, t["output"], 20000)
    assert p.min() >= 64 and p.max() <= 2048 and o.min() >= 16 \
        and o.max() <= 512
    assert abs(np.median(p) - 512) < 20 and abs(np.median(o) - 128) < 6


def test_rollout_steps():
    t = traffic("rollout")
    a, b = ClosedRollout(t, 99, 151936), ClosedRollout(t, 100, 151936)
    s0, s0b, s1 = a.step(0), a.step(0), b.step(0)
    assert key(s0) == key(s0b) and key(s0) != key(s1)
    assert len(s0) == 64
    # each group's 8 samples share one prompt, and the groups differ
    groups = {}
    for it in s0:
        groups.setdefault(it.group, set()).add(tuple(it.prompt))
    assert len(groups) == 8 and all(len(v) == 1 for v in groups.values())
    # the same sizes for every seed, in the same order; each step its own
    assert [(len(i.prompt), i.n_out) for i in s0] == \
        [(len(i.prompt), i.n_out) for i in s1]
    assert sorted(i.n_out for i in s0) != sorted(i.n_out for i in a.step(1))
    rng = np.random.default_rng(1)
    o = draw_lengths(rng, t["output"], 50000)
    p = draw_lengths(rng, t["prompt"], 50000)
    assert o.max() == 1024 and o.min() >= 1
    assert abs(np.median(o) - 377) < 10
    # the uncapped lognormal's 99th percentile is 2596.5: the cap takes
    # P(X > 1024) = 11.5% of the samples
    assert abs((o == 1024).mean() - 0.115) < 0.01
    assert p.max() <= 1352 and abs(p.mean() - 120.5) < 2


def test_longer_horizons_only_add_later_arrivals():
    t = dict(traffic("chat-bursty"), rate_per_s=3.0)
    short = open_schedule(t, 5, 151936, 50.0)
    long = open_schedule(t, 5, 151936, 70.0)
    assert len(long) > len(short)
    assert key(long[:len(short)]) == key(short)
