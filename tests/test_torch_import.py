"""The port's module contract: `repro_torch` imports no jax and nothing of
`repro`, its entry points default to CUDA, and without a card they raise
instead of moving to the CPU."""
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "n = sum(1 for m in sys.modules if m.startswith('repro_torch.'))\n"
        "print('ok', n)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 48     # every module was imported


def test_chip_smoke_imports_no_jax_or_repro():
    src = (REPO / "chip_smoke.py").read_text()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1]
            assert not mod.startswith(("jax", "repro.")) and mod != "repro", s


def _entry_points():
    from repro_torch.bridge import params_from_jax
    from repro_torch.core.switch_exec import SwitchExecutor
    from repro_torch.models.registry import init_params
    from repro_torch.serving.engine import MoebiusEngine
    from repro_torch.serving.steps import build_decode_loop, build_mixed_step
    return (init_params, MoebiusEngine, build_mixed_step, SwitchExecutor,
            build_decode_loop, params_from_jax)


@pytest.mark.parametrize("idx", [0, 1, 2, 3, 4, 5])
def test_entry_points_default_to_cuda(idx):
    fn = _entry_points()[idx]
    sig = inspect.signature(fn)
    assert sig.parameters["device"].default == "cuda"


def test_entry_points_raise_without_card(monkeypatch):
    from repro_torch.serving.kvcache import CacheConfig
    from tests._torch_common import port_tiny_moe
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (init_params, MoebiusEngine, build_mixed_step, SwitchExecutor,
     build_decode_loop, params_from_jax) = _entry_points()
    cfg = port_tiny_moe()
    cc = CacheConfig(page_size=4, pages_ep=8, max_pages_per_req=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_mixed_step(cfg, (1, 1), "tp", cc, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MoebiusEngine(cfg, (1, 1), cc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SwitchExecutor(cfg, cc, (1, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_decode_loop(cfg, (1, 1), "tp", cc, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": [1.0]})
    # the CPU runs only when asked for
    assert init_params(cfg, device="cpu")["embed"].device.type == "cpu"


def test_kernel_wrappers_do_not_fall_back():
    """A kernel wrapper given tensors off the card raises instead of
    running the plain version; the dispatchers refuse mixed devices."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.moe_gemm.kernel import grouped_matmul_cuda
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    x = torch.zeros(2, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul_cuda(x, torch.zeros(2, 8, 64))
    i32 = torch.int32
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(torch.zeros(1, 1, 1, 2, 64),
                             torch.zeros(1, 4, 4, 1, 64),
                             torch.zeros(1, 4, 4, 1, 64),
                             torch.zeros(1, 1, 2, dtype=i32),
                             torch.ones(1, 1, dtype=i32),
                             torch.zeros(1, 1, dtype=i32))
    with pytest.raises(ValueError, match="devices"):
        dispatch.use_kernel(x, torch.zeros(1, device="meta"))
    assert dispatch.use_kernel(x) is False
