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
        "for m in ('repro_torch.serving.qos', 'repro_torch.serving.faults',\n"
        "          'repro_torch.configs.qwen2_moe_a2_7b',\n"
        "          'repro_torch.serving.frontend', 'repro_torch.launch.serve',\n"
        "          'repro_torch.launch.http', 'repro_torch.serving.steps_extra',\n"
        "          'repro_torch.models.ssm', 'repro_torch.models.ssm_lm',\n"
        "          'repro_torch.models.hybrid', 'repro_torch.models.encdec',\n"
        "          'repro_torch.configs.mamba2_780m',\n"
        "          'repro_torch.configs.zamba2_2_7b',\n"
        "          'repro_torch.configs.whisper_base',\n"
        "          'repro_torch.configs.paligemma_3b',\n"
        "          'repro_torch.training.data', 'repro_torch.training.optimizer',\n"
        "          'repro_torch.training.train_loop',\n"
        "          'repro_torch.distributed.checkpoint',\n"
        "          'repro_torch.distributed.compression',\n"
        "          'repro_torch.distributed.collectives',\n"
        "          'repro_torch.launch.train', 'repro_torch.configs.shapes',\n"
        "          'repro_torch.launch.dryrun'):\n"
        "    assert m in sys.modules, m\n"
        "n = sum(1 for m in sys.modules if m.startswith('repro_torch.'))\n"
        "print('ok', n)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 81     # every module was imported


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


@pytest.mark.parametrize("fn", ["build_ssm_serve_step",
                                "build_hybrid_serve_step",
                                "build_encdec_serve_step", "ssm_states"])
def test_family_steps_default_to_cuda(fn, monkeypatch):
    """The SSM, hybrid and encoder-decoder steps (and the SSM states) run
    on the card unless the caller asks for the CPU; without a card they
    raise."""
    from repro_torch.configs import get_config
    from repro_torch.serving import steps_extra
    from repro_torch.serving.kvcache import CacheConfig
    f = getattr(steps_extra, fn)
    assert inspect.signature(f).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cc = CacheConfig(page_size=4, pages_ep=8, max_pages_per_req=4)
    args = {"build_ssm_serve_step": ("mamba2-780m", ((1, 2), "tp", 2)),
            "build_hybrid_serve_step": ("zamba2-2.7b", ((1, 2), "tp", cc, 2)),
            "build_encdec_serve_step": ("whisper-base",
                                        ((1, 2), "ep", cc, 2, 16)),
            "ssm_states": ("mamba2-780m", (1, 2))}[fn]
    cfg = get_config(args[0]).reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        f(cfg, *args[1])
    f(cfg, *args[1], device="cpu")


def test_launcher_defaults_to_cuda(monkeypatch):
    """`python -m repro_torch.launch.serve` runs on the card unless
    `--device cpu` is passed; without a card it raises."""
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--workload", "rollout", "--scale", "0.005"])


def test_train_entry_points_default_to_cuda(monkeypatch):
    """`build_train_step`, the checkpoint restore and `python -m
    repro_torch.launch.train` run on the card unless the caller asks for
    the CPU; without a card they raise."""
    from repro_torch.distributed.checkpoint import restore_checkpoint
    from repro_torch.launch.train import main
    from repro_torch.training.train_loop import build_train_step
    from tests._torch_common import port_tiny_moe
    for fn in (build_train_step, restore_checkpoint):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(port_tiny_moe(), "tp", 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--steps", "1"])
    build_train_step(port_tiny_moe(), "tp", 2, device="cpu")


def test_kernel_wrappers_do_not_fall_back():
    """A kernel wrapper given tensors off the card raises instead of
    running the plain version; the dispatchers refuse mixed devices."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.moe_gemm.kernel import (grouped_matmul_cuda,
                                                     grouped_swiglu_cuda)
    from repro_torch.kernels.paged_attention.kernel import \
        paged_attention_cuda
    x = torch.zeros(2, 4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        grouped_matmul_cuda(x, torch.zeros(2, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        grouped_swiglu_cuda(x.bfloat16(), torch.zeros(2, 8, 64).bfloat16())
    i32 = torch.int32
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(torch.zeros(1, 1, 1, 2, 64),
                             torch.zeros(1, 4, 4, 1, 64),
                             torch.zeros(1, 4, 4, 1, 64),
                             torch.zeros(1, 1, 2, dtype=i32),
                             torch.ones(1, 1, dtype=i32),
                             torch.zeros(1, 1, dtype=i32))
    with pytest.raises(ValueError, match="devices"):
        dispatch.device_kind(x, torch.zeros(1, device="meta"))
    assert dispatch.device_kind(x) == "cpu"
