"""Build the CUDA sources under `repro_torch/csrc/` with nvcc, load with ctypes.

Each `csrc/<name>.cu` exports a plain C interface and is compiled on first
use into `build/repro_torch/` at the root of the checkout (listed in
`.gitignore`) as `lib<name>-<source hash>.so`, so an edited source never
loads a stale library. No PyTorch headers are included: a build takes
seconds, not minutes. `build_all` starts one nvcc per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (proc or None, tmp path, final path)."""
    src, out = _target(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def build_all(names) -> dict[str, str]:
    """Compile every named source in parallel; returns nvcc's output per
    name (ptxas register/shared-memory report). Raises on any failure."""
    started = {n: _start(n) for n in names}
    logs, errors = {}, []
    for n, (proc, tmp, out) in started.items():
        if proc is None:
            logs[n] = "(cached)"
            continue
        text, _ = proc.communicate()
        logs[n] = text
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{text}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LIBS[name] = lib
    return lib
