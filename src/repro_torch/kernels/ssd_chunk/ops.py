"""Public SSD intra-chunk op: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors and with ``impl="ref"`` (``kernels/common.py``
holds the policy).

``ssd_chunk`` is a ``torch.autograd.Function``.  Its forward is the
hand-written kernel (``csrc/ssd_chunk.cu``) or ``ssd_chunk_ref``; it
saves the five inputs.  Its backward follows the same dispatch: the
hand-written backward (``csrc/ssd_chunk_bwd.cu``, counted as
``ssd_chunk_bwd``) on CUDA tensors, ``ssd_chunk_bwd_plain`` on CPU
tensors and with ``impl="ref"``.  The reference has no backward kernel
(``pallas_call`` has no VJP there, and JAX training differentiates the
inline einsums).

The kernels mask ragged L, H, P and N themselves, so no shape sends a
CUDA tensor to the plain version.  Both keep a tile's scores against at
most 256 positions on chip (a whole chunk at the configurations' 256 and
32) and walk a longer chunk in such windows, summing the windows'
partials in a float32 workspace the wrapper allocates.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import common
from .ref import ssd_chunk_bwd_plain, ssd_chunk_ref


def _check(name: str, x: torch.Tensor, dt: torch.Tensor,
           dA_cs: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
           **more: torch.Tensor) -> None:
    """Shapes, devices, dtypes and contiguity the kernels take; ``more``
    holds further operands of x's shape and dtype (dy)."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x [B, L, H, P] expected, got "
                         f"{tuple(x.shape)}")
    Bp, L, H, P = x.shape
    if tuple(dt.shape) != (Bp, L, H) or tuple(dA_cs.shape) != (Bp, L, H):
        raise ValueError(f"{name}: dt and dA_cs must be {(Bp, L, H)}, got "
                         f"{tuple(dt.shape)}, {tuple(dA_cs.shape)}")
    if Bm.dim() != 3 or tuple(Bm.shape[:2]) != (Bp, L) or \
            tuple(Cm.shape) != tuple(Bm.shape):
        raise ValueError(f"{name}: Bm and Cm must be [{Bp}, {L}, N], got "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    for key, t in more.items():
        if t.shape != x.shape:
            raise ValueError(f"{name}: {key} must be {tuple(x.shape)}, got "
                             f"{tuple(t.shape)}")
    floats = {"x": x, "Bm": Bm, "Cm": Cm, **more}
    common.check_kernel_args(name, floats, tuple(floats), x.device)
    common.check_kernel_args(name, {"dt": dt, "dA_cs": dA_cs},
                             ("dt", "dA_cs"), x.device)
    if dt.dtype != torch.float32:
        raise TypeError(f"{name}: dt and dA_cs must be float32, got "
                        f"{dt.dtype}")


def _launch(x: torch.Tensor, dt: torch.Tensor, dA_cs: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    name = "ssd_chunk"
    _check(name, x, dt, dA_cs, Bm, Cm)
    Bp, L, H, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    lib = common.library()
    with common.on_device(x):
        n_ws = lib.repro_ssd_chunk_workspace(Bp, L, H, P, N)
        if n_ws < 0:
            raise ValueError(f"{name}: sizes {(Bp, L, H, P, N)} not taken")
        ws = torch.empty(n_ws, dtype=torch.float32, device=x.device) \
            if n_ws else None
        status = lib.repro_ssd_chunk(
            *(common.ptr(t) for t in (x, dt, dA_cs, Bm, Cm, y)),
            common.ptr(ws) if ws is not None else None, Bp, L, H, P, N,
            int(x.dtype == torch.bfloat16), common.stream_of(x))
    common.check_status(name, status)
    common.LAUNCHES[name] += 1
    return y


def _launch_bwd(x: torch.Tensor, dt: torch.Tensor, dA_cs: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
    name = "ssd_chunk_bwd"
    _check(name, x, dt, dA_cs, Bm, Cm, dy=dy)
    Bp, L, H, P = x.shape
    N = Bm.shape[-1]
    lib = common.library()
    grads = (torch.empty_like(x), torch.empty_like(dt),
             torch.empty_like(dA_cs), torch.empty_like(Bm),
             torch.empty_like(Cm))
    with common.on_device(x):
        n_ws = lib.repro_ssd_chunk_bwd_workspace(Bp, L, H, P, N)
        if n_ws <= 0:
            raise ValueError(f"{name}: sizes {(Bp, L, H, P, N)} not taken")
        ws = torch.empty(n_ws, dtype=torch.float32, device=x.device)
        status = lib.repro_ssd_chunk_bwd(
            *(common.ptr(t) for t in (x, dt, dA_cs, Bm, Cm, dy, *grads, ws)),
            Bp, L, H, P, N, int(x.dtype == torch.bfloat16),
            common.stream_of(x))
    common.check_status(name, status)
    common.LAUNCHES[name] += 1
    return grads


def ssd_chunk_fwd(x: torch.Tensor, dt: torch.Tensor, dA_cs: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, *,
                  impl: Optional[str] = None) -> torch.Tensor:
    """One forward without autograd: the kernel or its plain version, as
    ``ssd_chunk`` would pick them."""
    if common.resolve_impl(x, impl) == "cuda":
        return _launch(x, dt, dA_cs, Bm, Cm)
    return ssd_chunk_ref(x, dt, dA_cs, Bm, Cm)


def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, dA_cs: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, dy: torch.Tensor, *,
                  impl: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, ddA_cs, dBm, dCm) for the upstream gradient ``dy``: the
    backward kernel or its plain version, as ``ssd_chunk`` would pick
    them."""
    if common.resolve_impl(x, impl) == "cuda":
        return _launch_bwd(x, dt, dA_cs, Bm, Cm, dy.contiguous())
    return ssd_chunk_bwd_plain(x, dt, dA_cs, Bm, Cm, dy)


class _SSDChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, dA_cs, Bm, Cm, impl):
        ctx.save_for_backward(x, dt, dA_cs, Bm, Cm)
        ctx.impl = impl
        return ssd_chunk_fwd(x, dt, dA_cs, Bm, Cm, impl=impl)

    @staticmethod
    def backward(ctx, dy):
        return (*ssd_chunk_bwd(*ctx.saved_tensors, dy, impl=ctx.impl), None)


def ssd_chunk(x: torch.Tensor,        # [B, L, H, P]
              dt: torch.Tensor,       # [B, L, H] float32
              dA_cs: torch.Tensor,    # [B, L, H] float32
              Bm: torch.Tensor,       # [B, L, N]
              Cm: torch.Tensor,       # [B, L, N]
              *, impl: Optional[str] = None) -> torch.Tensor:
    """The SSD intra-chunk output y [B, L, H, P] in ``x.dtype``,
    differentiable in all five inputs."""
    impl = common.resolve_impl(x, impl)
    return _SSDChunk.apply(x, dt, dA_cs, Bm, Cm, impl)
