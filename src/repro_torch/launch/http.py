"""Stdlib-only HTTP/SSE frontend over the AsyncEngine (DESIGN.md §11;
port of repro/launch/http.py, changed only in its docstring paths).

One asyncio event loop, no threads, no third-party deps: every request
handler *cooperatively pumps* the synchronous AsyncEngine — one engine
iteration per pump, `await asyncio.sleep(0)` in between — so any number
of concurrent HTTP streams interleave over the SAME continuous batch,
exactly like in-process `TokenStream`s. The engine sequence is identical
to batch mode, so SSE-streamed tokens are byte-for-byte the batch
`generate()` outputs, across live layout switches included
(tests/test_torch_http.py).

Endpoints:

  POST /v1/generate
      body: {"prompt": [token ids], "max_new_tokens": int,
             "slo_class": "interactive" | "batch" (default interactive),
             "stream": bool (default true),
             "max_time": seconds | null (per-request deadline: past it
             the request finishes truncated with whatever it generated)}
      stream=true  -> text/event-stream; one `data: {"token": id}` event
                      per generated token, then `data: [DONE]`. A client
                      that disconnects mid-stream gets its request
                      CANCELLED: the engine frees the slot/pages through
                      the normal finish path and other streams continue
                      (`client_disconnects` in /v1/metrics).
      stream=false -> application/json {"rid", "tokens", "n"}.

  GET /v1/metrics
      ServeMetrics.summary() as JSON — flat keys plus the per-class
      `by_class` breakdown (attainment, per-class p50/p99).

  GET /v1/layouts
      MoebiusEngine.layouts_summary() as JSON: the resident layouts with
      their worlds (device counts), the active layout, degraded (dead)
      pools, and switch/backoff state — the observability surface of
      elastic world-size switching (DESIGN.md §13).

Run it standalone via `python -m repro_torch.launch.serve --http-port 8000`;
quickstart curl lines are in the README.
"""
from __future__ import annotations

import asyncio
import json


def _sse(obj) -> bytes:
    data = obj if isinstance(obj, str) else json.dumps(obj)
    return f"data: {data}\n\n".encode()


class HttpFrontend:
    """Minimal HTTP/1.1 server bridging sockets to one AsyncEngine."""

    def __init__(self, frontend, host: str = "127.0.0.1", port: int = 0):
        self.fe = frontend
        self.host = host
        self.port = port                   # 0 = pick a free port
        self._server = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self) -> "HttpFrontend":
        self._server = await asyncio.start_server(self._handle, self.host,
                                                  self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        async with self._server:
            await self._server.serve_forever()

    # ------------------------------------------------------------------
    # request plumbing
    # ------------------------------------------------------------------
    async def _read_request(self, reader):
        """Parse one HTTP/1.1 request head + Content-Length body."""
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _ = line.decode().split(None, 2)
        except ValueError:
            return None
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", 0) or 0)
        body = await reader.readexactly(n) if n else b""
        return method.upper(), path, headers, body

    @staticmethod
    def _head(status: str, ctype: str, extra: str = "") -> bytes:
        return (f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                f"Cache-Control: no-cache\r\nConnection: close\r\n"
                f"{extra}\r\n").encode()

    async def _json(self, writer, obj, status: str = "200 OK") -> None:
        body = json.dumps(obj).encode()
        writer.write(self._head(status, "application/json",
                                f"Content-Length: {len(body)}\r\n"))
        writer.write(body)
        await writer.drain()

    async def _handle(self, reader, writer) -> None:
        try:
            req = await self._read_request(reader)
            if req is None:
                return
            method, path, _, body = req
            if method == "POST" and path == "/v1/generate":
                await self._generate(writer, body)
            elif method == "GET" and path == "/v1/metrics":
                await self._json(writer, self.fe.metrics.summary())
            elif method == "GET" and path == "/v1/layouts":
                await self._json(writer, self.fe.engine.layouts_summary())
            else:
                await self._json(writer, {"error": f"no route {method} "
                                                   f"{path}"},
                                 "404 Not Found")
        except (ConnectionError, asyncio.IncompleteReadError):
            pass                           # client went away mid-stream
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except ConnectionError:
                pass

    # ------------------------------------------------------------------
    # /v1/generate
    # ------------------------------------------------------------------
    async def _generate(self, writer, body: bytes) -> None:
        try:
            spec = json.loads(body or b"{}")
            prompt = [int(x) for x in spec["prompt"]]
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            await self._json(writer, {"error": f"bad request: {e!r}"},
                             "400 Bad Request")
            return
        max_time = spec.get("max_time")
        stream = self.fe.generate(
            prompt,
            max_new_tokens=int(spec.get("max_new_tokens", 16)),
            slo_class=str(spec.get("slo_class", "interactive")),
            max_time=float(max_time) if max_time is not None else None)
        if spec.get("stream", True):
            await self._stream_sse(writer, stream)
        else:
            toks = await self._drive(stream)
            await self._json(writer, {"rid": stream.rid, "tokens": toks,
                                      "n": len(toks)})

    async def _drive(self, stream) -> list:
        """Pump the shared engine loop until `stream` finishes, yielding
        to other handlers between iterations; returns all its tokens.
        Another handler's pump may finish this stream for us — only pump
        while the engine still has work."""
        toks = list(stream.drain_available())
        while not stream.finished:
            if self.fe.engine.sched.has_work():
                self.fe._pump()
            toks.extend(stream.drain_available())
            await asyncio.sleep(0)
        toks.extend(stream.drain_available())
        return toks

    async def _stream_sse(self, writer, stream) -> None:
        """Stream one request's tokens; a broken pipe mid-stream cancels
        the request (DESIGN.md §12) so its slot and pages go back to the
        batch instead of decoding for a client that is gone."""
        writer.write(self._head("200 OK", "text/event-stream"))
        try:
            await writer.drain()
            while True:
                # drain first, test finished after: a finished request
                # can't grow its output, so empty-after-drain + finished
                # == done
                for tok in stream.drain_available():
                    writer.write(_sse({"token": int(tok)}))
                await writer.drain()
                if stream.finished:
                    break
                if writer.transport.is_closing():
                    raise ConnectionResetError("client went away")
                if self.fe.engine.sched.has_work():
                    self.fe._pump()
                await asyncio.sleep(0)
            writer.write(_sse("[DONE]"))
            await writer.drain()
        except (ConnectionError, OSError):
            # handled here (not in _handle's net) so the cancel happens
            # even for non-Connection OSErrors; the writer closes in
            # _handle's finally either way
            if not stream.finished:
                self.fe.cancel(stream.rid)


async def serve_http(frontend, host: str = "127.0.0.1",
                     port: int = 8000) -> None:
    """Blocking entrypoint for `repro_torch.launch.serve --http-port`."""
    srv = await HttpFrontend(frontend, host, port).start()
    print(f"serving on http://{srv.host}:{srv.port} "
          f"(POST /v1/generate, GET /v1/metrics, GET /v1/layouts)",
          flush=True)
    await srv.serve_forever()
