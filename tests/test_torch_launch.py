"""The port's serving launcher (`repro_torch.launch.serve`) on the CPU:
each command of repro's launcher docstring (src/repro/launch/serve.py)
through `main(argv)` in-process with `--device cpu`, at a tiny `--scale`
(the reduced mixtral config, f32), and `--http-port 0` through a server
started in a subprocess, asked over HTTP on localhost, and stopped."""
import contextlib
import io
import json
import os
import subprocess
import sys
import urllib.request

import pytest
import torch

from repro_torch.launch.serve import main
from tests.helpers import REPO

torch.set_num_threads(1)

COMMANDS = {
    "rollout": "--workload rollout --scale 0.005 --mesh 1x4 --policy rollout",
    "bursty_tpep": "--workload bursty --scale 0.005 --mesh 2x4 "
                   "--layouts tp,ep,tpep",
    "static_tpep": "--workload rollout --scale 0.005 --mesh 2x4 "
                   "--policy static-tpep --layouts tp,ep,tpep",
    "elastic": "--workload bursty --scale 0.005 --mesh 2x4 "
               "--layouts tp,ep,tp@2",
    "qos_mix": "--workload bursty --scale 0.005 --mesh 1x4 "
               "--slo-class-mix 0.3",
}


def _main(argv: str) -> tuple[dict, dict]:
    """Run the launcher; returns (returned summary, printed summary)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = main(argv.split() + ["--device", "cpu"])
    return summary, json.loads(out.getvalue())


@pytest.mark.parametrize("name", list(COMMANDS))
def test_documented_command_runs(name):
    summary, printed = _main(COMMANDS[name])
    assert printed == json.loads(json.dumps(summary))
    assert summary["n"] > 0
    assert summary["streams_finished"] == summary["n"]
    layouts = COMMANDS[name].partition("--layouts ")[2].split(" ")[0]
    assert summary["layouts"] == (layouts or "tp,ep").split(",")
    assert summary["final_layout"] in summary["layouts"]
    if name == "static_tpep":
        assert summary["switches"] == 0 and summary["final_layout"] == "tpep"
    if name == "qos_mix":
        assert set(summary["by_class"]) == {"batch", "interactive"}
    for k in ("ttft_p50_s", "ttft_p99_s", "tpot_p50_s", "tpot_p99_s"):
        assert summary[k] >= 0, k


def test_static_tpep_fused_two_phase():
    """Static tpep with the fused loop and the two-phase iteration: every
    stream finishes at its length, as many tokens as the mixed per-token
    run of the same trace."""
    base, _ = _main(COMMANDS["static_tpep"])
    summary, _ = _main(COMMANDS["static_tpep"]
                       + " --decode-steps 4 --two-phase")
    assert summary["streams_finished"] == summary["n"] == base["n"]
    assert summary["total_tokens"] == base["total_tokens"]
    assert summary["final_layout"] == "tpep" and summary["switches"] == 0
    assert summary["decode_dispatches"] < base["decode_dispatches"]


def test_http_port_zero_serves_and_stops():
    """`--http-port 0` warms the engine, picks a free port, answers
    POST /v1/generate (streamed and not), GET /v1/layouts and
    GET /v1/metrics, and stops on SIGTERM."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mesh", "1x2", "--layouts", "tp,ep,tpep", "--http-port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        base = line.split()[2]

        def ask(path, payload=None):
            req = urllib.request.Request(
                base + path, method="POST" if payload else "GET",
                data=json.dumps(payload).encode() if payload else None)
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.read()

        out = json.loads(ask("/v1/generate", {
            "prompt": [5, 6, 7, 8], "max_new_tokens": 5, "stream": False}))
        assert out["n"] == 5 and len(out["tokens"]) == 5
        sse = ask("/v1/generate", {"prompt": [5, 6, 7, 8],
                                   "max_new_tokens": 5}).decode()
        toks = [json.loads(ln[6:])["token"] for ln in sse.splitlines()
                if ln.startswith("data: {")]
        assert toks == out["tokens"] and sse.rstrip().endswith("[DONE]")
        lay = json.loads(ask("/v1/layouts"))
        assert [lo["name"] for lo in lay["layouts"]] == ["tp", "ep", "tpep"]
        assert lay["active"] == "tp"
        assert json.loads(ask("/v1/metrics"))["n"] == 2
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert proc.returncode is not None
