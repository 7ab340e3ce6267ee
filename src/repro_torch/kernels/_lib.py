"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into
``build/kernels/lib<name>.so`` at the repository root (a plain C
interface, loaded with ``ctypes``; no PyTorch headers, so a build takes
seconds).  All sources build in parallel, at first use; a library newer
than its sources is reused.  Nothing here runs when the module is imported.

``LAUNCHES`` counts kernel launches by name.  Each launcher adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel name (= source csrc/<name>.cu) -> (C entry point, its argument types);
# every entry point returns cudaGetLastError() as an int
SIGNATURES = {
    "flash_attention": ("flash_attention", [_P] * 4 + [_I] * 7 + [_F, _F, _I, _P]),
    "decode_attention": ("decode_attention", [_P] * 4 + [_I, _P] + [_I] * 6 + [_F, _F, _I, _P]),
    "paged_attention": ("paged_decode_attention", [_P] * 6 + [_I] * 7 + [_F, _F, _I, _P]),
    "mamba_scan": ("mamba_scan", [_P] * 8 + [_I] * 6 + [_P]),
    "rolling_stats": ("rolling_stats", [_P] * 5 + [_I] * 4 + [_F] * 3 + [_P]),
}
KERNELS = tuple(SIGNATURES)

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
_FNS: Dict[str, ctypes._CFuncPtr] = {}
BUILD_LOG: Dict[str, str] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(path)


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < newest


def build_all(force: bool = False) -> float:
    """Compile every stale kernel library, one ``nvcc`` per source, all at
    once.  Returns the wall seconds spent; raises with the compiler's output
    if any build fails."""

    todo = [n for n in KERNELS if force or _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str):
    """The C entry point of kernel ``name``, its argument types set (the
    library is built first if needed, and loaded once)."""

    fn = _FNS.get(name)
    if fn is None:
        if _stale(name):
            build_all()
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(_lib_path(name))), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def check(status: int, name: str) -> None:
    """Raise if a launcher's C function reported a CUDA error."""

    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")


def dtype_code(t) -> int:
    """The kernels' element-type code: 0 float32, 1 bfloat16."""

    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")


def check_tensors(first, *rest, align: int = 16):
    """Shared validation of the launchers' tensor arguments: CUDA, one
    device, one dtype, contiguous, ``align``-byte aligned."""

    for t in (first, *rest):
        if t.device.type != "cuda":
            raise ValueError(f"kernel launch needs CUDA tensors, got {t.device}")
        if t.device != first.device:
            raise ValueError("all tensors must be on one device")
        if t.dtype != first.dtype:
            raise TypeError(f"dtype mismatch: {t.dtype} vs {first.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel tensors must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"kernel tensors must be {align}-byte aligned")


def check_attention_args(q, *caches):
    """Shared validation of the attention launchers' tensor arguments."""

    check_tensors(q, *caches)
    dtype_code(q)
    d = q.shape[-1]
    if d > 256 or d % 8:
        raise ValueError(f"head_dim must be <= 256 and a multiple of 8, got {d}")


def check_int_vector(t, name, n, device):
    if t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor on {device}")
    if t.shape[0] != n:
        raise ValueError(f"{name} has {t.shape[0]} rows, expected {n}")
