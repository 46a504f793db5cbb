"""BENCHMARK.json against the rules it is written to, and the import rule:
nothing the benchmark runs loads jax, jaxlib, flax or the JAX package
`repro` (compared by whole top-level module names: `repro_torch` starts
with `repro` and is allowed)."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_size|_dim|_rank|_width)$|experts_per_tok|expan")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and len(b["command"]) <= 32
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["why"]) <= 200
        f = ROOT / c["file"]
        assert f.exists() and c["file"].startswith("perfbench/")
        data = json.loads(f.read_text())
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and not WIDTH.search(k), k
    used = set()
    pairs = set()
    four = 0
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        four += w["chips"] == 4
    assert used == set(cfgs) and four <= max(1, len(b["workloads"]) // 4)
    cells = {w["name"] for w in b["workloads"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) <= 16
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").exists()
    for cell in cells:
        rep = [n for n, m in e2e.items() if cell in m.get("workloads", cells)]
        assert "setup_s" in rep and len(rep) >= 2
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        mv = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert c in cells and c in mv.get("workloads", cells), (m, c)
        assert (BENCH / "metrics" / f"{m['name'].split('.')[0]}.py").exists()
    assert len(json.dumps(b)) <= 64 * 1024
    for p in BENCH.rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_no_jax_or_repro():
    bad = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    for f in BENCH.rglob("*.py"):
        assert not (_top_imports(f) & bad), f
    for f in (BENCH / "reference").rglob("*.py"):
        # the reference takes nothing of the program
        assert "repro_torch" not in _top_imports(f), f


def test_whole_top_level_names():
    sys.path.insert(0, str(BENCH))
    spec_code = (
        "import sys, importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('r', {str(BENCH / 'run.py')!r})\n"
        "r = importlib.util.module_from_spec(spec); sys.modules['r'] = r; spec.loader.exec_module(r)\n"
        "r._environment()\n"
        "import harness.serve, harness.check, harness.trace, reference.moe_lm\n"
        "import repro_torch.serving.engine, repro_torch.core.policy\n"
        "assert r.forbidden_modules() == [], r.forbidden_modules()\n"
        "assert 'repro_torch' in {m.split('.')[0] for m in sys.modules}\n"
        "import types; sys.modules['repro'] = types.ModuleType('repro')\n"
        "assert r.forbidden_modules() == ['repro']\n"
        "del sys.modules['repro']; sys.modules['jaxlib.x'] = types.ModuleType('x')\n"
        "assert r.forbidden_modules() == ['jaxlib']\n"
        "print('ok')\n")
    p = subprocess.run([sys.executable, "-c", spec_code], capture_output=True,
                       text=True, cwd=ROOT, timeout=120)
    assert p.returncode == 0 and p.stdout.strip() == "ok", p.stderr
