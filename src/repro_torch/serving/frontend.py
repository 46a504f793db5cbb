"""The serving frontend's clock (port of repro/serving/frontend.py, the
`VirtualClock` only; the streaming `AsyncEngine` comes with the serving
features).

Pass a `VirtualClock` as `EngineConfig.clock` for a fully deterministic
replay: time moves only when advanced. The engine's trace-replay idle
fast-forward calls `advance_to` to jump quiet periods, and its per-dispatch
charge (`EngineConfig.dispatch_dt`) calls `advance`.
"""
from __future__ import annotations


class VirtualClock:
    """Deterministic injectable clock: time moves only when advanced."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, float(t))
