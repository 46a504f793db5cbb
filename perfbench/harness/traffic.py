"""The one traffic generator: it reads a traffic file's parameters.

Two loops, named by the file's "loop":

* "closed": RL rollout steps. Each step is `groups` prompts, each sampled
  `samples` times (the GRPO shape: the samples of a group share their
  prompt byte for byte). The next step is due when the last sample of the
  previous one has finished, so the card paces the load.
* "open": independent users. Arrivals follow a Poisson process at
  `rate_per_s` times the multiple of the current phase of `cycle`
  ([[seconds, multiple], ...], repeated); without a cycle the rate is
  steady.

Lengths are drawn from the file's distributions: "lognormal" from its
median and 99th percentile, "gamma" from its shape and mean (the
arithmetic of the port's `serving/workloads.rollout_batch`), each clipped
to [min, max].

Every seed gets the same sizes and arrival times, in the same order. The
sizes (and, for an open loop, the arrival times of each phase) are drawn
from the file's `shape_seed`; the run's seed draws only the token ids, so
two seeds do the same work (a shuffle of the sizes changed which requests
coincide, and with it the tails, more than a repeat of one seed did).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

Z99 = 2.3263478740408408          # the standard normal's 99th percentile


@dataclass
class Item:
    offset_s: float       # due time after the window opened (open loop)
    prompt: list
    n_out: int
    group: int            # rollout: the prompt group; open loop: -1


def draw_lengths(rng, d: dict, n: int) -> np.ndarray:
    if d["dist"] == "lognormal":
        mu = math.log(d["median"])
        sigma = (math.log(d["p99"]) - mu) / Z99
        x = np.exp(mu + sigma * rng.standard_normal(n)).astype(np.int64)
    elif d["dist"] == "gamma":
        x = rng.gamma(d["shape"], d["mean"] / d["shape"], n).astype(
            np.int64) + 1
    elif d["dist"] == "fixed":
        x = np.full(n, int(d["value"]), np.int64)
    else:
        raise ValueError(f"unknown length distribution {d['dist']!r}")
    return np.clip(x, d["min"], d["max"])


def _rng(*key) -> np.random.Generator:
    return np.random.default_rng([int(k) & ((1 << 63) - 1) for k in key])


def max_tokens(t: dict) -> int:
    """The longest prompt plus output the file can make."""
    return int(t["prompt"]["max"]) + int(t["output"]["max"])


class ClosedRollout:
    """Rollout steps, one at a time (`step(k)`)."""

    def __init__(self, t: dict, seed: int, vocab: int):
        self.t, self.seed, self.vocab = t, seed, vocab

    def step(self, k: int) -> list[Item]:
        t = self.t
        g, s = int(t["groups"]), int(t["samples"])
        shape = _rng(t["shape_seed"], 1, k)
        plens = draw_lengths(shape, t["prompt"], g)
        outs = draw_lengths(shape, t["output"], g * s)
        run = _rng(self.seed, 2, k)
        items = []
        for j in range(g):
            prompt = run.integers(1, self.vocab, int(plens[j])).tolist()
            for i in range(s):
                items.append(Item(0.0, prompt, int(outs[j * s + i]), j))
        return items


def open_schedule(t: dict, seed: int, vocab: int, horizon_s: float
                  ) -> list[Item]:
    """Every arrival due in [0, horizon_s), in time order. Each phase of
    the cycle (each `horizon_s` stretch without one) draws its own count,
    times and sizes, so with a cycle a longer horizon only adds arrivals
    after the shorter one's."""
    rate = float(t["rate_per_s"])
    cycle = t.get("cycle") or [[horizon_s, 1.0]]
    items, a, j = [], 0.0, 0
    while a < horizon_s:
        dur, mult = cycle[j % len(cycle)]
        b = a + float(dur)
        shape = _rng(t["shape_seed"], 3, j)
        run = _rng(seed, 4, j)
        n = int(shape.poisson(rate * float(mult) * float(dur)))
        times = np.sort(shape.uniform(a, b, n))
        plens = draw_lengths(shape, t["prompt"], n)
        outs = draw_lengths(shape, t["output"], n)
        for i in range(n):
            if times[i] < horizon_s:
                items.append(Item(float(times[i]), run.integers(
                    1, vocab, int(plens[i])).tolist(), int(outs[i]), -1))
        a, j = b, j + 1
    return items
