"""Build and bind the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source compiles on its own with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``build/repro_torch/lib<name>.so`` at the root of the checkout, at first
use, and is bound with ``ctypes``: every pointer (and the CUDA stream) is a
``c_void_p``, and every launch function returns ``cudaGetLastError()`` so
the wrapper raises on a refused launch.  Nothing here runs at import time;
the sources in the repository are the only input.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

__all__ = ["BUILD_DIR", "CSRC", "DTYPE_CODES", "ROUTE_CODES", "build_all",
           "check_launch", "library", "stream_handle"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# route codes of csrc/hopper.cuh (plan.gemm_route, plan.attention_route,
# plan.attention_bwd_route, plan.expert_route and plan.expert_bwd_route
# pick the route)
ROUTE_CODES = {"simt": 0, "wgmma": 1}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# library -> (source, {function: argtypes})
LIBRARIES: Dict[str, tuple] = {
    "matmul": ("matmul.cu", {
        "repro_matmul": [_P, _P, _P, _I, _I, _I, _I, _I, _P]}),
    "ring_matmul": ("ring_matmul.cu", {
        "repro_ring_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P]}),
    "wave_step": ("wave_step.cu", {
        "repro_leap": [_P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P, _LL, _LL,
                       _LL, _F, _P, _LL, _LL, _LL, _I, _I, _I, _I, _I, _F,
                       _I, _P]}),
    "fused_wave_step": ("fused_wave_step.cu", {
        "repro_fused_wave_step": [_P, _P, _P, _F, _P, _P, _P] + [_I] * 6
        + [_F, _I, _P],
        "repro_fused_wave_step_carried": [_P, _P, _P, _F] + [_P] * 5
        + [_I] * 5 + [_F, _I, _P]}),
    "expert_mlp": ("expert_mlp.cu", {
        "repro_expert_mlp": [_P] * 8 + [_LL] * 3 + [_I] * 8 + [_P]}),
    "moe_dispatch": ("moe_dispatch.cu", {
        "repro_moe_dispatch": [_P] * 11 + [_LL] * 3 + [_I] * 10 + [_P]}),
    "expert_mlp_bwd": ("expert_mlp_bwd.cu", {
        "repro_expert_mlp_bwd": [_P] * 12 + [_LL] * 3 + [_I] * 9 + [_P]}),
    "moe_dispatch_bwd": ("moe_dispatch_bwd.cu", {
        "repro_moe_dispatch_bwd": [_P] * 16 + [_LL] * 3 + [_I] * 11
        + [_P]}),
    "linear_scan": ("linear_scan.cu", {
        "repro_linear_scan": [_P] * 7 + [_I] * 7 + [_P]}),
    "linear_scan_bwd": ("linear_scan_bwd.cu", {
        "repro_linear_scan_bwd": [_P] * 13 + [_I] * 5 + [_P]}),
    "flash_attention": ("flash_attention.cu", {
        "repro_flash_attention": [_P, _LL, _LL, _LL, _LL] * 4
        + [_P, _P] + [_I] * 11 + [_F, _I, _I, _I] + [_P] * 5,
        "repro_flash_combine": [_P] * 4 + [_LL] * 4 + [_I] * 7 + [_P]}),
    "flash_attention_bwd": ("flash_attention_bwd.cu", {
        "repro_flash_attention_bwd": [_P] * 12 + [_I] * 9
        + [_F, _I, _I, _P]}),
    "ring_attention": ("ring_attention.cu", {
        "repro_ring_attention": [_P] * 11 + [_I, _P, _P] + [_I] * 12
        + [_F, _I, _I, _P]}),
    "ring_attention_bwd": ("ring_attention_bwd.cu", {
        "repro_ring_attention_bwd": [_P] * 16 + [_I, _P, _I, _P, _P]
        + [_I] * 11 + [_F, _I, _I, _P]}),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _stale(name: str) -> bool:
    so = BUILD_DIR / f"lib{name}.so"
    if not so.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
    return so.stat().st_mtime < newest


def build_all(names: Iterable[str] = tuple(LIBRARIES)) -> Dict[str, str]:
    """Compile every stale library, one ``nvcc`` per source, all started
    together; returns each library's compiler output (registers, shared
    memory and spills from ``-Xptxas -v``).  Raises if any build fails."""
    names = [n for n in names if _stale(n)]
    if not names:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        src = CSRC / LIBRARIES[name][0]
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, BUILD_DIR / f"lib{name}.so")
        (BUILD_DIR / f"lib{name}.log").write_text(out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The bound library ``name``, built first if it is missing or stale."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
            for fn, argtypes in LIBRARIES[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _loaded[name] = lib
        return lib


def stream_handle(device: torch.device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(status: int, what: str) -> None:
    """Raise if a launch function reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
