"""On a card: run.py end to end on the tiny fixture through the CUDA
kernels (the same cells as the CPU rehearsal), with its device fields.
Marked `cuda`; skips where torch sees no card (decided in the test)."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
DATA = BENCH / "tests" / "data" / "BENCHMARK.json"


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_on_the_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "tiny.rollout",
         "--seed", str(2**31 + 77), "--seconds", "5", "--trace", str(trace),
         "--bench-file", str(DATA)], capture_output=True, text=True,
        cwd=BENCH.parent, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert len(res["breakdown"]["device_ops"]) <= 10
    else:
        assert set(res["metrics"]) == {"gen_tok_s", "setup_s"}
