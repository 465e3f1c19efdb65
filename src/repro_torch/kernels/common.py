"""Shared kernel plumbing for the PyTorch/CUDA port.

Every hand-written Hopper kernel lives in `repro_torch/csrc/*.cu` behind a
plain C entry point. The sources are compiled on first use with `nvcc` for
`sm_90a` into one shared library under `build/repro_torch/<hash>/` at the
repository root (the hash covers the sources and the flags, so an edit
rebuilds), and loaded with `ctypes`. Nothing is compiled at import time: the
CPU tests import every module on machines with no CUDA toolkit.

Dispatch rule shared by every `ops.py`: a tensor on the CPU goes to the
kernel's plain PyTorch version in `ref.py`; a tensor on a CUDA device
launches the kernel, or raises if the build or the launch fails. There is no
fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# Products are never fused into adds (--fmad=false): the kernels then follow
# the arithmetic order of their plain versions, which makes them bit-equal.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)

def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pad_axis(x: torch.Tensor, axis: int, multiple: int, value) -> torch.Tensor:
    """Pad `axis` of x up to a multiple; returns x unchanged if aligned."""
    size = x.shape[axis]
    pad = (-size) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


# ------------------------------------------------------------------ devices
def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; CUDA must exist when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie on
    the CPU; raises on a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors lie on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless `t` has the dtype, the shape and a contiguous layout the
    kernel reads."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


# -------------------------------------------------------------------- build
def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build_library(verbose: bool = False) -> Path:
    """Compile every `csrc/*.cu` (one nvcc each, all at once) and link them
    into one shared library. Returns its path; a built library is reused."""
    lib = BUILD_ROOT / _digest() / "librepro_torch.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out = lib.parent
    out.mkdir(parents=True, exist_ok=True)
    units = [p for p in _sources() if p.suffix == ".cu"]
    procs = []
    for src in units:
        obj = out / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, _, p in procs:
        log, _ = p.communicate()
        if verbose or p.returncode:
            print(f"[nvcc {src.name}]\n{log}", flush=True)
        if p.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}")
    tmp = out / f"{lib.name}.{os.getpid()}.tmp"
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode:
        raise RuntimeError(f"linking the kernel library failed:\n{res.stdout}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    dll = ctypes.CDLL(str(build_library()))
    dll.repro_cuda_error_string.argtypes = [ctypes.c_int]
    dll.repro_cuda_error_string.restype = ctypes.c_char_p
    return dll


def kernel_fn(name: str, argtypes: list):
    """A C entry point of the kernel library with its signature declared.
    Each returns the `cudaError_t` of its launch."""
    fn = getattr(_library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_launch(rc: int, name: str) -> None:
    if rc != 0:
        msg = _library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}): {msg}")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on t's device, for a launch."""
    return torch.cuda.current_stream(t.device).cuda_stream


PTR = ctypes.c_void_p
INT = ctypes.c_int
