"""Kernel dispatch, device policy and the CUDA build.

Dispatch follows the tensor, never an environment variable:

  * a CUDA tensor runs the hand-written kernel (``impl=None`` or
    ``impl="cuda"``) — or raises; it never reaches the plain version by
    default;
  * a CPU tensor runs the plain PyTorch version; asking for the kernel on
    it (``impl="cuda"``) raises;
  * ``impl="ref"`` runs the plain version on any device — the comparison
    lane of ``chip_smoke.py``.

The kernels are CUDA C++ for ``sm_90a`` under ``csrc/``, compiled with
``nvcc`` into ONE shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so the build takes seconds).  The build
happens at first use, from this package's sources only, into
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a
hash of the sources and flags.  Each source compiles in its own ``nvcc``
process, all started together; a missing ``nvcc`` or a failed compile
raises with the compiler's output.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

IMPLS = ("ref", "cuda")

# launches per kernel wrapper; bumped only where a kernel is launched
LAUNCHES: Dict[str, int] = {"kv_append_chunk": 0, "paged_attention_chunk": 0,
                             "paged_attention_append_chunk": 0,
                             "flash_attention": 0, "flash_attention_bwd": 0,
                             "ssd_chunk": 0, "ssd_chunk_bwd": 0}
# context splits the last launch of a split kernel ran with
LAST_SPLITS: Dict[str, int] = {}

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: Optional[ctypes.CDLL] = None
_SMS: Dict[int, int] = {}
BUILD_INFO: Dict[str, object] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve_device(device) -> torch.device:
    """The port's entry-point device policy: ``device`` defaults to
    ``"cuda"`` at every entry point, and a CUDA request on a machine
    without a card raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False;"
            " pass device='cpu' to run the plain PyTorch path")
    return dev


def resolve_impl(t: torch.Tensor, impl: Optional[str]) -> str:
    """``ref`` or ``cuda`` for a call whose main operand is ``t``."""
    if impl is None:
        return "cuda" if t.is_cuda else "ref"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and not t.is_cuda:
        raise ValueError("the CUDA kernel needs CUDA tensors; got a tensor "
                         f"on {t.device}")
    return impl


def check_kernel_args(name: str, tensors: Dict[str, torch.Tensor],
                      float_keys, device: torch.device) -> None:
    """Device, dtype and contiguity checks shared by the wrappers: every
    operand on ``device`` and contiguous; float operands bf16 or fp32 and
    of one dtype; index operands int32."""
    fdt = None
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if key in float_keys:
            if t.dtype not in (torch.bfloat16, torch.float32):
                raise TypeError(f"{name}: {key} must be bfloat16 or float32, "
                                f"got {t.dtype}")
            if fdt is not None and t.dtype != fdt:
                raise TypeError(f"{name}: {key} is {t.dtype}, expected {fdt}")
            fdt = t.dtype
        elif t.dtype != torch.int32:
            raise TypeError(f"{name}: {key} must be int32, got {t.dtype}")


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t "
                           f"{status}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def on_device(t: torch.Tensor):
    """Make ``t``'s card current for a launch (a no-op when it is)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels of repro_torch are built from source at "
                       "first use and need the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cus, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, in parallel) and
    link them into one shared library; reuse it when the source hash
    matches.  Returns the library path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True, log="")
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cus, _ = _sources()
    procs = []
    for src in cus:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs))
    tmp = out_dir / f"lib.{os.getpid()}.so.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *[str(obj) for _, obj, _ in procs]],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib)
    BUILD_INFO.update(path=str(lib), seconds=time.perf_counter() - t0,
                      cached=False, log="\n".join(logs))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_kv_append_chunk.argtypes = [
            vp, vp, vp, vp, i32, i32, i32, i32, vp]
        lib.repro_kv_append_chunk.restype = i32
        lib.repro_paged_attention_chunk.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp,
            i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,
            f32, f32, i32, vp]
        lib.repro_paged_attention_chunk.restype = i32
        lib.repro_paged_attention_append_chunk.argtypes = [
            vp] * 12 + [i32] * 10 + [f32, f32, i32, vp]
        lib.repro_paged_attention_append_chunk.restype = i32
        lib.repro_flash_attention.argtypes = [
            vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32,
            f32, f32, i32, vp]
        lib.repro_flash_attention.restype = i32
        lib.repro_flash_attention_bwd_workspace.argtypes = [i32] * 7
        lib.repro_flash_attention_bwd_workspace.restype = ctypes.c_longlong
        lib.repro_flash_attention_bwd.argtypes = [vp] * 10 + [i32] * 8 + [
            f32, f32, i32, vp]
        lib.repro_flash_attention_bwd.restype = i32
        lib.repro_ssd_chunk_workspace.argtypes = [i32] * 5
        lib.repro_ssd_chunk_workspace.restype = ctypes.c_longlong
        lib.repro_ssd_chunk.argtypes = [vp] * 7 + [i32] * 6 + [vp]
        lib.repro_ssd_chunk.restype = i32
        lib.repro_ssd_chunk_bwd_workspace.argtypes = [i32] * 5
        lib.repro_ssd_chunk_bwd_workspace.restype = ctypes.c_longlong
        lib.repro_ssd_chunk_bwd.argtypes = [vp] * 12 + [i32] * 6 + [vp]
        lib.repro_ssd_chunk_bwd.restype = i32
        _LIB = lib
    return _LIB
