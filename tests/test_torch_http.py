"""The port's HTTP/SSE frontend (launch/http.py, DESIGN.md §11) on the
CPU: tests/test_http.py's six checks on the port's engine (tiny configs,
f32, one rank).

The HTTP layer is an observation layer over the same AsyncEngine event
loop: SSE-streamed tokens must equal the batch `generate()` outputs
byte-for-byte — across a live layout switch included — and `/v1/metrics`
must serve the per-class summary without touching the flat keys.
"""
import asyncio
import json

import numpy as np
import torch

from repro_torch.core.policy import PolicyConfig
from repro_torch.launch.http import HttpFrontend
from repro_torch.serving.engine import EngineConfig, MoebiusEngine
from repro_torch.serving.frontend import AsyncEngine, VirtualClock
from repro_torch.serving.kvcache import CacheConfig
from tests._torch_common import port_tiny_dense, port_tiny_moe

torch.set_num_threads(1)


def _mk(cfg):
    pol = PolicyConfig(t_high=10**9, t_low=-1, cooldown_s=10**9)
    eng = MoebiusEngine(cfg, (1, 1),
                        CacheConfig(page_size=4, pages_ep=64,
                                    max_pages_per_req=16),
                        ecfg=EngineConfig(start_layout="tp", ladder=(4, 8),
                                          prefill_chunk=8, temperature=0.0,
                                          policy=pol, clock=VirtualClock()),
                        device="cpu")
    return AsyncEngine(eng, step_dt=0.01)


def _prompt(seed=0, n=6):
    return [int(x) for x in np.random.default_rng(seed).integers(5, 200, n)]


async def _request(srv, method, path, payload=None):
    """One HTTP round-trip; returns (status_line, header_block, body)."""
    reader, writer = await asyncio.open_connection(srv.host, srv.port)
    body = json.dumps(payload).encode() if payload is not None else b""
    writer.write((f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, payload = raw.partition(b"\r\n\r\n")
    status, _, hdrs = head.decode().partition("\r\n")
    return status, hdrs, payload


def _sse_tokens(payload: bytes) -> list[int]:
    toks = []
    for line in payload.split(b"\n"):
        line = line.strip()
        if line.startswith(b"data: ") and line != b"data: [DONE]":
            toks.append(json.loads(line[6:])["token"])
    return toks


def test_sse_stream_matches_batch_across_live_switch():
    """SSE tokens == batch generate() outputs byte-for-byte, with a live
    tp->ep switch injected after the first streamed event (client and
    server share one loop, so the switch lands between iterations)."""
    prompt = _prompt()
    ref = _mk(port_tiny_moe()).generate(list(prompt),
                                         max_new_tokens=10).tokens()
    assert len(ref) == 10

    async def run():
        fe = _mk(port_tiny_moe())
        srv = await HttpFrontend(fe).start()
        try:
            reader, writer = await asyncio.open_connection(srv.host,
                                                           srv.port)
            body = json.dumps({"prompt": prompt,
                               "max_new_tokens": 10}).encode()
            writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                          f"Content-Length: {len(body)}\r\n\r\n").encode()
                         + body)
            await writer.drain()
            toks, switched = [], False
            while True:
                line = (await reader.readline()).strip()
                if line == b"data: [DONE]":
                    break
                if not line.startswith(b"data: "):
                    continue
                toks.append(json.loads(line[6:])["token"])
                if not switched:
                    fe.engine.execute_switch("ep")
                    switched = True
            writer.close()
            await writer.wait_closed()
            return toks, switched, str(fe.engine.active)
        finally:
            await srv.close()

    toks, switched, final = asyncio.run(run())
    assert switched and final == "ep"
    assert toks == ref


def test_non_streaming_generate_and_metrics():
    """stream=false returns the full token list as JSON; /v1/metrics
    serves the flat summary keys plus the per-class breakdown, with the
    request's slo_class tag showing up."""
    prompt = _prompt(seed=1)
    ref = _mk(port_tiny_dense()).generate(list(prompt),
                                           max_new_tokens=8).tokens()

    async def run():
        fe = _mk(port_tiny_dense())
        srv = await HttpFrontend(fe).start()
        try:
            status, _, body = await _request(
                srv, "POST", "/v1/generate",
                {"prompt": prompt, "max_new_tokens": 8, "stream": False,
                 "slo_class": "interactive"})
            status2, _, body2 = await _request(srv, "GET", "/v1/metrics")
            status3, _, _ = await _request(srv, "GET", "/nope")
        finally:
            await srv.close()
        return status, json.loads(body), status2, json.loads(body2), status3

    status, out, status2, summary, status3 = asyncio.run(run())
    assert "200" in status and "200" in status2 and "404" in status3
    assert out["tokens"] == ref and out["n"] == 8
    for k in ("ttft_p50_s", "tpot_p99_s", "n", "total_tokens"):
        assert k in summary                     # flat keys unchanged
    assert summary["n"] == 1
    bc = summary["by_class"]["interactive"]
    assert bc["n"] == 1 and "attainment" in bc
    assert bc["ttft_target_s"] == 1.0


def test_concurrent_sse_streams_interleave():
    """Two SSE clients share the engine's continuous batch: both complete
    with their full token counts while pumping cooperatively."""
    async def run():
        fe = _mk(port_tiny_dense())
        srv = await HttpFrontend(fe).start()
        try:

            async def one(seed, n):
                _, _, payload = await _request(
                    srv, "POST", "/v1/generate",
                    {"prompt": _prompt(seed=seed), "max_new_tokens": n})
                return _sse_tokens(payload)

            a, b = await asyncio.gather(one(2, 7), one(3, 9))
        finally:
            await srv.close()
        return a, b, fe.metrics.summary()

    a, b, summary = asyncio.run(run())
    assert len(a) == 7 and len(b) == 9
    assert summary["n"] == 2
    assert summary["by_class"]["interactive"]["n"] == 2


def test_bad_request_is_a_400_not_a_crash():
    async def run():
        fe = _mk(port_tiny_dense())
        srv = await HttpFrontend(fe).start()
        try:
            status, _, body = await _request(srv, "POST", "/v1/generate",
                                             {"max_new_tokens": 4})
            status2, _, _ = await _request(
                srv, "POST", "/v1/generate",
                {"prompt": prompt_bad, "max_new_tokens": 4})
        finally:
            await srv.close()
        return status, json.loads(body), status2

    prompt_bad = ["not", "ints"]
    status, body, status2 = asyncio.run(run())
    assert "400" in status and "error" in body
    assert "400" in status2


# ---------------------------------------------------------------------------
# robustness (DESIGN.md §12): client disconnect + per-request deadline
# ---------------------------------------------------------------------------

def test_sse_client_disconnect_cancels_request():
    """A client that drops its socket mid-stream gets its request
    CANCELLED: the slot/pages go back through the normal finish path, a
    concurrent stream finishes untouched, and /v1/metrics counts it."""
    async def run():
        fe = _mk(port_tiny_dense())
        srv = await HttpFrontend(fe).start()
        try:
            # long-running victim stream: read 2 tokens, then RST the
            # socket (abort() skips the FIN handshake, so the server's
            # next drain/write raises instead of buffering silently)
            reader, writer = await asyncio.open_connection(srv.host,
                                                           srv.port)
            body = json.dumps({"prompt": _prompt(seed=4),
                               "max_new_tokens": 64}).encode()
            writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                          f"Content-Length: {len(body)}\r\n\r\n").encode()
                         + body)
            await writer.drain()
            got = 0
            while got < 2:
                line = (await reader.readline()).strip()
                if line.startswith(b"data: ") and line != b"data: [DONE]":
                    got += 1
            writer.transport.abort()

            # a second, well-behaved stream must finish normally
            _, _, payload = await _request(
                srv, "POST", "/v1/generate",
                {"prompt": _prompt(seed=5), "max_new_tokens": 6})

            # let the abandoned handler observe the dead socket and
            # cancel; it pumps cooperatively with us
            for _ in range(200):
                if fe.metrics.client_disconnects:
                    break
                await asyncio.sleep(0)
            return (_sse_tokens(payload), fe.metrics.summary(),
                    fe.engine.sched.finished, fe.engine.alloc)
        finally:
            await srv.close()

    toks, summary, finished, alloc = asyncio.run(run())
    assert len(toks) == 6
    assert summary["client_disconnects"] == 1
    canceled = [r for r in finished if r.canceled]
    assert len(canceled) == 1 and len(canceled[0].output) < 64
    for a in alloc:
        a.check()                      # refcounts conserved after cancel


def test_max_time_deadline_truncates():
    """`max_time` bounds a request in engine-clock seconds: past the
    deadline it finishes truncated with whatever it generated, and the
    truncation is counted in /v1/metrics."""
    async def run():
        fe = _mk(port_tiny_dense())     # VirtualClock + step_dt=0.01
        srv = await HttpFrontend(fe).start()
        try:
            status, _, body = await _request(
                srv, "POST", "/v1/generate",
                {"prompt": _prompt(seed=6), "max_new_tokens": 5000,
                 "stream": False, "max_time": 0.25})
            _, _, mbody = await _request(srv, "GET", "/v1/metrics")
        finally:
            await srv.close()
        return status, json.loads(body), json.loads(mbody), fe

    status, out, summary, fe = asyncio.run(run())
    assert "200" in status
    # admission clamps 5000 to the page cap (57 here); the deadline must
    # cut even below that
    assert 0 < out["n"] < 57, "deadline must cut the request short"
    assert summary["deadline_truncations"] == 1
    r = fe.engine.sched.finished[0]
    assert r.truncated and r.finish_s >= r.deadline_s
    fe.engine.alloc[0].check()
