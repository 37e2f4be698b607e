"""Public fused-attention op: the CUDA kernel on CUDA tensors, the plain
flash schedule on CPU tensors and with ``impl="ref"``
(``kernels/common.py`` holds the policy).

``attention`` is a ``torch.autograd.Function``.  Its forward is the
hand-written kernel (``csrc/flash_attention.cu``) or ``blockwise_fwd``;
both return the output and the row log-sum-exp, and the forward saves
``(q, k, v, out, lse)``.  Its backward follows the same dispatch: the
hand-written backward (``csrc/flash_attention_bwd.cu``, counted as
``flash_attention_bwd``) on CUDA tensors, ``blockwise_bwd`` on CPU tensors
and with ``impl="ref"``.  The reference has no backward kernel (it
differentiates ``attention_ref``); ``tiled.py`` mirrors the backward
kernel's schedule for the CPU tests.

The kernel masks ragged edges itself, so no shape sends a CUDA tensor to
the plain version; only ``q_offset`` and ``lengths``, which no model
passes to this op, are refused on the card (the plain lane runs them
through the dense oracle).  The bf16 kernel loads its tiles by TMA, which
addresses 16-byte-aligned bases and 16-byte row strides: ``tma_operands``
pads a head dim that is not a multiple of 8 with zero columns (they change
no score and give zero output columns and grads, sliced off) and copies a
base that is not on 16 bytes.  A head dim that is a multiple of 8 on an
aligned base (every model's) launches as it is; so does the backward's
upstream gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import common
from .blockwise import blockwise_bwd, blockwise_fwd
from .ref import attention_ref

MAX_HEAD_DIM = 256
TMA_ALIGN = 16            # bytes: TMA's base and row-stride granularity


def tma_operands(*ts: torch.Tensor):
    """``ts`` (bf16 [..., D], contiguous) as the bf16 kernel can address
    them: the head dim padded with zeros to a multiple of 8 elements and
    every base on 16 bytes; tensors that already are come back as they
    are."""
    pad = -ts[0].shape[-1] % (TMA_ALIGN // 2)
    if pad:
        return tuple(torch.nn.functional.pad(t, (0, pad)) for t in ts)
    return tuple(t if t.data_ptr() % TMA_ALIGN == 0 else t.clone()
                 for t in ts)


def _check(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], softcap: Optional[float],
           **more: torch.Tensor) -> None:
    """Shapes, options, devices, dtypes and contiguity the kernels take;
    ``more`` holds further operands of q's shape and dtype (out, dO)."""
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{name}: q [B,Sq,H,D] and k/v [B,Sk,KV,D] expected,"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Sk, KV, Dk = k.shape
    if k.shape[0] != B or Dk != D or H % KV:
        raise ValueError(f"{name}: shape mismatch q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {D} > {MAX_HEAD_DIM} is not "
                         "supported by the CUDA kernel")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{name}: softcap must be positive, got {softcap}")
    if window is not None and window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    for key, t in more.items():
        if t.shape != q.shape:
            raise ValueError(f"{name}: {key} must be {tuple(q.shape)}, got "
                             f"{tuple(t.shape)}")
    floats = {"q": q, "k": k, "v": v, **more}
    common.check_kernel_args(name, floats, tuple(floats), q.device)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], softcap: Optional[float]):
    name = "flash_attention"
    _check(name, q, k, v, window, softcap)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = float(D ** -0.5)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = tma_operands(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = common.library()
    with common.on_device(q):
        status = lib.repro_flash_attention(
            common.ptr(q), common.ptr(k), common.ptr(v), common.ptr(out),
            common.ptr(lse), B, Sq, Sk, H, KV, q.shape[-1], int(causal),
            -1 if window is None else int(window), scale,
            0.0 if softcap is None else float(softcap), int(bf16),
            common.stream_of(q))
    common.check_status(name, status)
    common.LAUNCHES[name] += 1
    if out.shape[-1] != D:
        out = out[..., :D].contiguous()
    return out, lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, impl):
        out, lse = attention_fwd(q, k, v, causal=causal, window=window,
                                 softcap=softcap, impl=impl)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        impl=impl)
        return out

    @staticmethod
    def backward(ctx, g):
        dq, dk, dv = attention_bwd(*ctx.saved_tensors, g, **ctx.opts)
        return dq, dk, dv, None, None, None, None


def attention(q: torch.Tensor,            # [B, Sq, H, D]
              k: torch.Tensor,            # [B, Sk, KV, D]
              v: torch.Tensor,            # [B, Sk, KV, D]
              *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, q_offset: int = 0,
              lengths: Optional[torch.Tensor] = None,
              impl: Optional[str] = None) -> torch.Tensor:
    """Fused attention entry point used by every model block."""
    impl = common.resolve_impl(q, impl)
    if q_offset != 0 or lengths is not None:
        if impl == "cuda":
            raise NotImplementedError(
                "flash_attention: the CUDA kernel takes neither q_offset nor "
                "lengths (no model passes them); use impl='ref'")
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, softcap=softcap,
                             lengths=lengths)
    return _FlashAttention.apply(q, k, v, causal, window, softcap, impl)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  impl: Optional[str] = None):
    """(out, lse) of one forward, without autograd: the kernel or its
    plain version, as ``attention`` would pick them."""
    if common.resolve_impl(q, impl) == "cuda":
        return _launch(q, k, v, causal, window, softcap)
    return blockwise_fwd(q, k, v, causal=causal, window=window,
                         softcap=softcap)


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                causal: bool, window: Optional[int],
                softcap: Optional[float]):
    name = "flash_attention_bwd"
    _check(name, q, k, v, window, softcap, out=out, g=g)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be float32 {(B, H, Sq)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    common.check_kernel_args(name, {"lse": lse}, ("lse",), q.device)
    scale = float(D ** -0.5)
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v, out, g = tma_operands(q, k, v, out, g)
    Dp = q.shape[-1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = common.library()
    with common.on_device(q):
        n_ws = lib.repro_flash_attention_bwd_workspace(B, Sq, Sk, H, KV, Dp,
                                                       int(bf16))
        if n_ws <= 0:
            raise ValueError(f"{name}: sizes {(B, Sq, Sk, H, KV, Dp)} not "
                             "taken")
        ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
        status = lib.repro_flash_attention_bwd(
            *(common.ptr(t) for t in (q, k, v, out, lse, g, dq, dk, dv, ws)),
            B, Sq, Sk, H, KV, Dp, int(causal),
            -1 if window is None else int(window), scale,
            0.0 if softcap is None else float(softcap), int(bf16),
            common.stream_of(q))
    common.check_status(name, status)
    common.LAUNCHES[name] += 1
    if Dp != D:
        dq, dk, dv = (x[..., :D].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  impl: Optional[str] = None):
    """(dq, dk, dv) of ``sum(out * g)`` from one forward's ``out`` and
    ``lse``, without autograd: the backward kernel or ``blockwise_bwd``,
    as ``attention`` would pick them."""
    if common.resolve_impl(q, impl) == "cuda":
        return _launch_bwd(q, k, v, out, lse, g.contiguous(), causal, window,
                           softcap)
    return blockwise_bwd(q, k, v, out, lse, g, causal=causal, window=window,
                         softcap=softcap)
