"""Build and load the port's hand-written CUDA kernels.

Each source under `ray_tpu_torch/csrc/` is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into a shared library with a plain C interface under `build/kernels/` at
the root of the checkout (listed in .gitignore), named by a hash of the
source, and loaded with ctypes. Nothing is compiled at import: the CPU
tests import every module on a host without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of each source's entry points: name -> (argtypes, restype)
SIGNATURES = {
    "paged_attention": {
        "paged_attention_launch": (
            [_P] * 10 + [_I] * 8 + [_F] + [_I, _I] + [_P], _I,
        ),
    },
    "flash_attention": {
        # pointers, then B, H, KV, Lq, Lk, D (flash_dqkv: B, H, Lq, Lk, D),
        # scale, causal, is_bf16, stream
        "flash_fwd_launch": ([_P] * 5 + [_I] * 6 + [_F, _I, _I, _P], _I),
        "flash_dq_launch": ([_P] * 7 + [_I] * 6 + [_F, _I, _I, _P], _I),
        "flash_dkv_launch": ([_P] * 8 + [_I] * 6 + [_F, _I, _I, _P], _I),
        "flash_dqkv_launch": ([_P] * 9 + [_I] * 5 + [_F, _I, _I, _P], _I),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc's output (-Xptxas -v) per kernel


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _target(name: str) -> Path:
    digest = hashlib.sha1((_CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, target) or
    None when the library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def build(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, one nvcc each,
    all started together. Raises RuntimeError with nvcc's output when a
    build fails."""
    started = {}
    for name in names:
        job = _start(name)
        if job is not None:
            started[name] = job
    errors = []
    for name, (proc, tmp, out) in started.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build loads either file
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed, with
    the argtypes and restype of each entry point set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = restype
            _libs[name] = lib
        return lib
