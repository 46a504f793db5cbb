"""run.py end to end on the CPU: a tiny MoE with a shared expert, through
the kernels' plain versions (a rehearsal: its numbers come out under
"rehearsal", never as metrics), the control failing where the program
passes, and faults planted under the timed path turning `correct` false.
"""
import contextlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = BENCH / "tests" / "data" / "BENCHMARK.json"
SEED = 2**31 + 5


def cmd(workload, seed=SEED, seconds=6, extra=()):
    return ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", "0", "--device", "cpu", "--bench-file",
            str(DATA), *extra]


def run_main(argv):
    """run.py's main in this process; its last stdout line, parsed, and
    the line before it (the run's log)."""
    spec = importlib.util.spec_from_file_location("pb_run", BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["pb_run"] = mod
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main(argv) == 0
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]), json.loads(lines[-2])


def test_rehearsal_end_to_end_subprocess():
    p = subprocess.run([sys.executable, str(BENCH / "run.py"),
                        *cmd("tiny.rollout")], capture_output=True,
                       text=True, cwd=ROOT, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] > 0
    assert res["metrics"] == {} and "rehearsal" in res
    assert res["device"]["platform"] == "cpu"
    assert "busy_s" not in res["device"]
    assert p.stderr.strip().splitlines()[-1].startswith("check ")


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "qwen3-235b.rollout", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_control_fails_where_the_program_holds():
    # the rollout fixture serves the most tokens in a short window; on the
    # chat fixture's ~200 a bf16 product flips no argmax on some seeds
    res, log = run_main(cmd("tiny.rollout", extra=("--control", "1")))
    assert res["correct"] is True
    assert log["control"]["below"]["correct"] is False
    assert log["control"]["below"]["mean_gap"] > \
        res["checks"]["mean_gap"]["limit"]


def _faults():
    from repro_torch.distributed import ranks
    from repro_torch.serving import steps

    def altered(orig):                   # a token altered where produced
        def f(cfg, *a, **k):
            return (orig(cfg, *a, **k) + 1) % cfg.vocab_size
        return f

    def half(orig):                      # half of the batch gets no FFN
        def f(cfg, lpk, h, *a, **k):
            y = orig(cfg, lpk, h, *a, **k).clone()
            y[:, y.shape[1] // 2:] = 0
            return y
        return f

    return {
        "token_altered": [(steps, "_sample", altered)],
        "half_batch_left_out": [(steps, "_ffn", half)],
        "exchange_left_out": [(ranks, "all_to_all", lambda o: lambda x: x),
                              (ranks, "psum", lambda o: lambda x: x)],
        "state_unchanged": [(steps, "_write_pages",
                             lambda o: lambda *a, **k: None)],
    }


@pytest.mark.parametrize("fault", ["token_altered", "half_batch_left_out",
                                   "exchange_left_out", "state_unchanged"])
@pytest.mark.parametrize("workload", ["tiny.rollout", "tiny.chat"])
def test_faults_under_the_timed_path_fail(fault, workload, monkeypatch):
    res0, _ = run_main(cmd(workload, seed=SEED + 1))
    assert res0["correct"] is True
    for mod, name, wrap in _faults()[fault]:
        monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))
    res, log = run_main(cmd(workload, seed=SEED + 1))
    assert res["correct"] is False, log["check"]
