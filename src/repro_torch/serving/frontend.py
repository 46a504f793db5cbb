"""AsyncEngine: the streaming continuous-batching frontend (DESIGN.md §7;
port of repro/serving/frontend.py, changed only in its package path).

`AsyncEngine.generate()` returns a `TokenStream` — an iterator that yields
each generated token id the moment the engine produces it. Pulling a
stream drives the shared arrival-driven event loop (one `MoebiusEngine`
iteration per pump), so any number of concurrent streams interleave over
the SAME continuous batch: tokens for other requests buffer in their
streams while you iterate one. The engine sequence is identical to batch
mode — streaming is an observation layer, not a different execution — so
streamed tokens are byte-for-byte the batch outputs, across live layout
switches included (tests/test_torch_frontend.py).

The loop runs under the engine's injectable clock (`EngineConfig.clock`):
wall time (scaled by `time_scale`) by default, or a `VirtualClock` for
fully deterministic replay — `step_dt` advances it per iteration and the
engine's trace-replay idle fast-forward (`EngineConfig.idle_skip`) jumps
it over quiet periods, so wall time is independent of quiet-period length.
Per-request TTFT/TPOT land in `ServeMetrics` (`summary()` carries
p50/p99); `switch pauses` sit between two engine iterations — a stream
simply sees a longer gap between two tokens, never a lost or reordered
one.

Preemption is invisible to a stream: a teacher-force-requeued request
folds its generated tokens into the prompt and re-prefills to the exact
same continuation, and `TokenStream` indexes generated tokens through the
fold, so delivery stays monotone and byte-stable.
"""
from __future__ import annotations

from repro_torch.serving.engine import MoebiusEngine
from repro_torch.serving.request import Request, State


class VirtualClock:
    """Deterministic injectable clock: time moves only when advanced.

    Pass as `EngineConfig.clock`; the engine's idle fast-forward calls
    `advance_to` to jump quiet periods, and the AsyncEngine loop calls
    `advance` once per iteration (`step_dt`)."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt

    def advance_to(self, t: float) -> None:
        self.t = max(self.t, float(t))


class TokenStream:
    """Iterator over one request's generated tokens, as produced.

    Robust to preemption/rank-failure requeue: generated token `i` lives
    either in the folded prompt tail (teacher-forced re-prefill) or in
    `output`, and both are byte-stable, so `i` indexes a fixed sequence.
    """

    def __init__(self, frontend: "AsyncEngine", req: Request):
        self._fe = frontend
        self.req = req
        self._base = req.prompt_len        # original prompt length
        self._given = 0

    @property
    def rid(self) -> int:
        return self.req.rid

    def _generated(self) -> int:
        return (self.req.prompt_len - self._base) + len(self.req.output)

    def _token_at(self, i: int) -> int:
        folded = self.req.prompt_len - self._base
        if i < folded:
            return int(self.req.prompt[self._base + i])
        return int(self.req.output[i - folded])

    @property
    def finished(self) -> bool:
        return self.req.state is State.FINISHED

    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self) -> int:
        while True:
            if self._given < self._generated():
                tok = self._token_at(self._given)
                self._given += 1
                return tok
            if self.finished:
                raise StopIteration
            self._fe._pump()

    def tokens(self) -> list[int]:
        """Drain the stream to completion (drives the event loop)."""
        return list(self)

    def drain_available(self) -> list[int]:
        """Already-produced tokens not yet taken, WITHOUT pumping the
        event loop — the non-blocking read the HTTP/SSE frontend
        (launch/http.py) interleaves with cooperative pumps."""
        out = []
        while self._given < self._generated():
            out.append(self._token_at(self._given))
            self._given += 1
        return out


class AsyncEngine:
    """Streaming frontend over one `MoebiusEngine`.

    `generate()`/`submit()` enqueue work; iterating any returned
    `TokenStream` (or calling `run_until_complete`) pumps the shared event
    loop: admission -> policy/switch -> ONE token-budgeted mixed dispatch
    per iteration (two phases under `mixed_batch=False`), with arrivals
    drawn from the engine clock. Submissions must be
    arrival-ordered (the admission queue is a deque scanned at its head —
    the same trace-replay contract as `MoebiusEngine.submit`); requests
    without an explicit `arrival_s` arrive "now", which is always ordered.
    """

    def __init__(self, engine: MoebiusEngine, step_dt: float | None = None,
                 stall_limit: int = 10000):
        self.engine = engine
        self.streams: dict[int, TokenStream] = {}
        self._next_rid = 0
        # per-iteration virtual-clock advance (VirtualClock only): models
        # the decode-step latency so TTFT/TPOT are deterministic step
        # counts instead of wall measurements
        self.step_dt = step_dt
        # live-lock backstop: consecutive iterations with zero observable
        # progress (queues, tokens, finishes all frozen) before the loop
        # raises instead of spinning forever — e.g. a request whose prompt
        # can never acquire its prefill pages. Legitimate idle spins while
        # waiting on a future arrival are exempt (idle_skip jumps those).
        self.stall_limit = stall_limit
        self._stalled = 0
        self._progress = None

    # ------------------------------------------------------------------
    # submission
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> TokenStream:
        """Register an explicit Request and return its token stream."""
        self._next_rid = max(self._next_rid, req.rid + 1)
        stream = TokenStream(self, req)
        self.streams[req.rid] = stream
        self.engine.submit(req)
        return stream

    def generate(self, prompt, max_new_tokens: int = 16, *,
                 arrival_s: float | None = None, rid: int | None = None,
                 forced_len: int | None = None,
                 slo_class: str = "interactive",
                 max_time: float | None = None) -> TokenStream:
        """Stream tokens for one prompt as the engine produces them.

        Returns immediately; iterate the stream (or call `.tokens()`) to
        drive the event loop. `arrival_s=None` arrives at the current
        engine clock (real-time submission). Streaming callers default to
        the `interactive` SLO class (serving/qos.py) — batch traffic
        should say so (`slo_class="batch"`). `max_time` is a per-request
        deadline in engine-clock seconds from arrival: past it the request
        finishes truncated with whatever it generated (DESIGN.md §12)."""
        if rid is None:
            rid = self._next_rid
        t = self.engine.now() if arrival_s is None else arrival_s
        req = Request(rid=rid, prompt=list(prompt),
                      max_new_tokens=max_new_tokens, arrival_s=t,
                      forced_len=forced_len, slo_class=str(slo_class),
                      deadline_s=(t + max_time) if max_time is not None
                      else None)
        return self.submit(req)

    def cancel(self, rid: int, *, kind: str = "disconnect") -> bool:
        """Cancel a live request (SSE client disconnect): the engine
        finishes it immediately and frees its slot/pages. The stream stays
        registered — it reads as finished with whatever was generated."""
        return self.engine.cancel(rid, kind=kind)

    # ------------------------------------------------------------------
    # the event loop
    # ------------------------------------------------------------------
    def _pump(self) -> None:
        """One engine iteration; advances a VirtualClock by step_dt."""
        sched = self.engine.sched
        if not sched.has_work():
            # a stream is waiting on a request the engine will never run
            stuck = [rid for rid, s in self.streams.items() if not s.finished]
            raise RuntimeError(f"event loop idle with unfinished streams "
                               f"{stuck} (request dropped?)")
        self.engine.step()
        if self.step_dt is not None:
            adv = getattr(self.engine._clock, "advance", None)
            if adv is not None:
                adv(self.step_dt)
        # stall backstop: a frozen fingerprint means no queue movement, no
        # prefill compute, no decoded tokens — nothing will ever change
        fp = (len(sched.pending), len(sched.waiting), len(sched.prefilling),
              len(sched.running), len(sched.finished),
              self.engine.metrics.prefill_tokens,
              self.engine.metrics.decode_tokens)
        # exempt idle spins toward a future arrival ONLY when the clock
        # can actually get there: idle_skip jumps it, the default wall
        # clock advances by itself, step_dt advances a VirtualClock — a
        # frozen injected clock without any of those would wait forever,
        # which is exactly what the backstop must catch
        clock_advances = (self.engine.ecfg.idle_skip
                          or self.engine._clock is None
                          or self.step_dt is not None)
        waiting_arrival = (clock_advances and not sched.waiting
                          and not sched.prefilling and not sched.running
                          and bool(sched.pending))
        if fp != self._progress or waiting_arrival:
            self._progress, self._stalled = fp, 0
            return
        self._stalled += 1
        if self._stalled >= self.stall_limit:
            stuck = [r.rid for r in sched.waiting]
            raise RuntimeError(
                f"no scheduling progress in {self.stall_limit} iterations; "
                f"requests stuck in waiting: {stuck} (prompt can never "
                f"acquire its prefill pages? check CacheConfig pool sizes)")

    def run_until_complete(self) -> dict:
        """Drive the loop until every submitted request finished; returns
        the metrics summary (TTFT/TPOT p50/p99 included)."""
        while self.engine.sched.has_work():
            self._pump()
        self.engine.ex.drain_decode()
        return self.engine.metrics.summary()

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def metrics(self):
        return self.engine.metrics

    def warmup(self, layouts=None) -> None:
        self.engine.warmup(layouts)
