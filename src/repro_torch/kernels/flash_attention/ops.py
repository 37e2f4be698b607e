"""Public fused-attention op: the CUDA kernel on CUDA tensors, the plain
flash schedule on CPU tensors and with ``impl="ref"``
(``kernels/common.py`` holds the policy).

``attention`` is a ``torch.autograd.Function``.  Its forward is the
hand-written kernel (``csrc/flash_attention.cu``) or ``blockwise_fwd``;
both return the output and the row log-sum-exp, and the forward saves
``(q, k, v, out, lse)``.  Its backward is ``blockwise_bwd`` on every
device, as the reference's backward is autodiff of plain code and not a
TPU kernel.

The kernel masks ragged edges itself, so no shape sends a CUDA tensor to
the plain version; only ``q_offset`` and ``lengths``, which no model
passes to this op, are refused on the card (the plain lane runs them
through the dense oracle).  The bf16 kernel loads its tiles by TMA, which
addresses 16-byte-aligned bases and 16-byte row strides: ``tma_operands``
pads a head dim that is not a multiple of 8 with zero columns (they change
no score and give zero output columns, sliced off) and copies a base that
is not on 16 bytes.  A head dim that is a multiple of 8 on an aligned
base (every model's) launches as it is.
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: Optional[int], softcap: Optional[float]):
    name = "flash_attention"
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
    common.check_kernel_args(name, {"q": q, "k": k, "v": v},
                             ("q", "k", "v"), q.device)
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
        ctx.opts = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.opts
        dq, dk, dv = blockwise_bwd(q, k, v, out, lse, g, causal=causal,
                                   window=window, softcap=softcap)
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
