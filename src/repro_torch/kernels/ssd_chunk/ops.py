"""Public SSD intra-chunk op: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors and with ``impl="ref"`` (``kernels/common.py``
holds the policy).

``ssd_chunk`` is a ``torch.autograd.Function``.  Its forward is the
hand-written kernel (``csrc/ssd_chunk.cu``) or ``ssd_chunk_ref``; it
saves the five inputs.  Its backward is ``ssd_chunk_bwd_plain`` on every
device: the reference has no backward kernel (``pallas_call`` has no
VJP there, and JAX training differentiates the inline einsums).

The kernel masks ragged L, H, P and N itself, so no shape sends a CUDA
tensor to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import common
from .ref import ssd_chunk_bwd_plain, ssd_chunk_ref


def _launch(x: torch.Tensor, dt: torch.Tensor, dA_cs: torch.Tensor,
            Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    name = "ssd_chunk"
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
    common.check_kernel_args(name, {"x": x, "Bm": Bm, "Cm": Cm},
                             ("x", "Bm", "Cm"), x.device)
    common.check_kernel_args(name, {"dt": dt, "dA_cs": dA_cs},
                             ("dt", "dA_cs"), x.device)
    if dt.dtype != torch.float32:
        raise TypeError(f"{name}: dt and dA_cs must be float32, got "
                        f"{dt.dtype}")
    y = torch.empty_like(x)
    lib = common.library()
    with common.on_device(x):
        status = lib.repro_ssd_chunk(
            common.ptr(x), common.ptr(dt), common.ptr(dA_cs), common.ptr(Bm),
            common.ptr(Cm), common.ptr(y), Bp, L, H, P, Bm.shape[-1],
            int(x.dtype == torch.bfloat16), common.stream_of(x))
    common.check_status(name, status)
    common.LAUNCHES[name] += 1
    return y


def ssd_chunk_fwd(x: torch.Tensor, dt: torch.Tensor, dA_cs: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor, *,
                  impl: Optional[str] = None) -> torch.Tensor:
    """One forward without autograd: the kernel or its plain version, as
    ``ssd_chunk`` would pick them."""
    if common.resolve_impl(x, impl) == "cuda":
        return _launch(x, dt, dA_cs, Bm, Cm)
    return ssd_chunk_ref(x, dt, dA_cs, Bm, Cm)


class _SSDChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, dA_cs, Bm, Cm, impl):
        ctx.save_for_backward(x, dt, dA_cs, Bm, Cm)
        return ssd_chunk_fwd(x, dt, dA_cs, Bm, Cm, impl=impl)

    @staticmethod
    def backward(ctx, dy):
        return (*ssd_chunk_bwd_plain(*ctx.saved_tensors, dy), None)


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
