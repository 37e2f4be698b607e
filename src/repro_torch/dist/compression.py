"""Gradient compression for the slow links between ranks (port of
``repro/dist/compression.py``).

Blockwise int8 quantization with error feedback: each 256-element block
gets its own scale (max-abs / 127), the quantization residual is carried
in a persistent accumulator and re-injected into the next step's update,
so the *sum* of applied updates tracks the true sum (unbiased over time).
``topk_sparsify`` is the magnitude-sparsification alternative for even
slower links; ``topk_psum`` puts it on the same error-feedback reduction
path as the int8 codec.

``plan_buckets`` / ``bucketed_compressed_psum`` split a gradient tree into
size-capped buckets (leaves in ``repro_torch.tree.leaves`` order: sorted
dict keys, list order, as JAX flattens) and run one compressed reduction
per bucket.
Each bucket carries its *own* error-feedback residual; residual state
therefore is a list of flat buffers, one per bucket, and each rank keeps
its own (collapsing them to one rank's copy breaks the telescoping
guarantee).

The reference's ``axis_name`` (a ``shard_map`` manual axis) is a
``torch.distributed`` process group here, one process per rank, every
rank holding the whole tensors.  The mean is ``all_reduce(SUM)`` of the
*dequantized* float32 values (top-k: of the dense kept values) divided
by the group's size, as the reference's ``pmean`` runs on dequantized
values: the int8 / sparse wire formats are what a roofline prices, not
what travels.  Everything is float32 and in the reference's order of
operations, so one rank's results are the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..tree import leaves as tree_leaves, unflatten

BLOCK = 256
_QMAX = 127.0

# 4 Mi elements = 16 MiB of f32 per bucket: large enough to amortize the
# collective launch, small enough that ~tens of buckets exist to overlap.
DEFAULT_BUCKET_ELEMS = 1 << 22

CODECS = ("int8", "topk")


def _pad_amount(n: int, block: int = BLOCK) -> int:
    return (-n) % block


def quantize_int8(x: torch.Tensor, *, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Blockwise-scaled int8 quantization of any-shaped ``x``.

    Returns ``(q [nblocks, block] int8, scale [nblocks, 1] f32, pad)``;
    ``pad`` is the zero padding added to reach a whole number of blocks.
    Roundtrip error is bounded by ``scale / 2`` per element
    (round-half-to-even of ``x / scale``).
    """
    flat = x.reshape(-1).to(torch.float32)
    pad = _pad_amount(flat.numel(), block)
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / _QMAX
    scale = torch.clamp_min(scale, torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(blocks / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale, pad


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, pad: int,
                    shape: Sequence[int]) -> torch.Tensor:
    """Inverse of ``quantize_int8``: strips ``pad`` and restores ``shape``."""
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:flat.numel() - pad]
    return flat.reshape(tuple(shape))


def quantize_with_feedback(g: torch.Tensor, err: torch.Tensor, *,
                           block: int = BLOCK):
    """Error-feedback quantization: quantize ``g + err`` and return the new
    residual.  Summed dequantized outputs telescope to the true gradient
    sum minus the (bounded) final residual."""
    x = g.to(torch.float32) + err.to(torch.float32)
    q, scale, pad = quantize_int8(x, block=block)
    new_err = x - dequantize_int8(q, scale, pad, x.shape)
    return q, scale, pad, new_err


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    """The group mean of ``x`` on every rank, in place: all_reduce(SUM),
    then a division by the group's size (the reference's ``pmean``)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.div_(dist.get_world_size(group))


def compressed_psum(flat: torch.Tensor, err: torch.Tensor, group
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce ``flat`` across ``group`` through the int8 +
    error-feedback codec.

    Each rank quantizes its local ``flat + err``, keeps the residual
    locally, and the *dequantized* values are averaged: the int8 wire
    would carry 1 byte/element + one f32 scale per block instead of
    4 B/element; here, as in the reference, the mean runs on the
    dequantized f32 values.
    """
    q, scale, pad, new_err = quantize_with_feedback(flat, err)
    deq = dequantize_int8(q, scale, pad, flat.shape)
    return _mean(deq, group), new_err


def topk_sparsify(x: torch.Tensor, frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the ``frac`` largest-magnitude entries of ``x``.

    Returns ``(vals, mask)`` where ``vals = x * mask``.  The threshold is
    the k-th largest |x| (k = round(frac * n), at least 1); ties at the
    threshold are all kept (>=), so the kept count can slightly exceed k.
    A dropped entry is +0.0, as XLA computes the reference's product (a
    select), where a float product would give -0.0 for negative entries.
    """
    flat = x.reshape(-1).abs()
    k = max(1, int(round(frac * flat.numel())))
    thresh = torch.topk(flat, k).values[-1]
    mask = x.abs() >= thresh
    return torch.where(mask, x, 0.0), mask


def topk_psum(flat: torch.Tensor, err: torch.Tensor, group, *,
              frac: float = 0.01) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-reduce ``flat`` across ``group`` through the top-k codec with
    error feedback: sparsify ``flat + err``, keep the dropped mass as the
    new residual.  ``reduced + mean(new_err) == mean(flat + err)`` holds
    *exactly* (dropping an entry is exact in floating point).  The wire
    would carry ~``frac`` (value, index) pairs per element; the mean runs
    dense, as the reference's.
    """
    x = flat.to(torch.float32) + err.to(torch.float32)
    vals, _ = topk_sparsify(x, frac)
    new_err = x - vals
    return _mean(vals, group), new_err


# ---------------------------------------------------------------- bucketing


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static partition of a tree's leaves into size-capped buckets.

    ``groups[b]`` are the (contiguous, flatten-order) leaf indices in
    bucket ``b``; ``sizes[b]`` is the unpadded element count and
    ``padded_sizes[b]`` rounds it up to a whole number of codec blocks.
    """
    groups: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    padded_sizes: Tuple[int, ...]

    @property
    def num_buckets(self) -> int:
        return len(self.groups)


def plan_buckets(leaf_sizes: Sequence[int], *,
                 bucket_elems: int = DEFAULT_BUCKET_ELEMS,
                 block: int = BLOCK) -> BucketPlan:
    """Greedy contiguous packing: walk the leaves in flatten order and
    close a bucket when adding the next leaf would exceed
    ``bucket_elems``.  A single leaf larger than the cap gets a bucket of
    its own — leaves are never split, so unbucketing is a pure reshape.
    """
    if bucket_elems < 1:
        raise ValueError(f"bucket_elems must be >= 1, got {bucket_elems}")
    groups: List[Tuple[int, ...]] = []
    sizes: List[int] = []
    cur: List[int] = []
    cur_size = 0
    for i, n in enumerate(leaf_sizes):
        if cur and cur_size + int(n) > bucket_elems:
            groups.append(tuple(cur))
            sizes.append(cur_size)
            cur, cur_size = [], 0
        cur.append(i)
        cur_size += int(n)
    if cur:
        groups.append(tuple(cur))
        sizes.append(cur_size)
    padded = tuple(s + _pad_amount(s, block) for s in sizes)
    return BucketPlan(groups=tuple(groups), sizes=tuple(sizes),
                      padded_sizes=padded)


def init_residuals(plan: BucketPlan, *, pod_size: int = 1,
                   device="cpu") -> List[torch.Tensor]:
    """Zero error-feedback buffers, one per bucket.  ``pod_size > 1``
    returns the *global* view (one residual row per rank, concatenated on
    dim 0, rank-major): the layout a checkpoint holds."""
    return [torch.zeros((pod_size * n,), dtype=torch.float32, device=device)
            for n in plan.padded_sizes]


def _reduce_one(flat: torch.Tensor, err: torch.Tensor, group, *,
                codec: str, topk_frac: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    if codec == "int8":
        return compressed_psum(flat, err, group)
    if codec == "topk":
        return topk_psum(flat, err, group, frac=topk_frac)
    raise ValueError(f"unknown codec {codec!r}; expected one of {CODECS}")


def bucket_flat(leaves: Sequence[torch.Tensor], plan: BucketPlan, b: int
                ) -> torch.Tensor:
    """Bucket ``b``'s leaves as one flat float32 vector, zero-padded to
    whole codec blocks."""
    parts = [leaves[i].reshape(-1).to(torch.float32) for i in plan.groups[b]]
    flat = parts[0] if len(parts) == 1 else torch.cat(parts)
    pad = plan.padded_sizes[b] - plan.sizes[b]
    return F.pad(flat, (0, pad)) if pad else flat


def bucket_leaves(flat: torch.Tensor, leaves: Sequence[torch.Tensor],
                  plan: BucketPlan, b: int) -> List[Tuple[int, torch.Tensor]]:
    """Bucket ``b``'s flat vector cut back into its leaves' shapes and
    dtypes (views where the dtype is float32): ``(leaf index, tensor)``
    for each leaf of the bucket; ``leaves`` give the shapes."""
    out, off = [], 0
    for i in plan.groups[b]:
        n = leaves[i].numel()
        out.append((i, flat[off:off + n].reshape(leaves[i].shape).to(
            leaves[i].dtype)))
        off += n
    return out


def bucketed_compressed_psum(tree: Any, residuals: Sequence[torch.Tensor],
                             group, *, plan: BucketPlan,
                             codec: str = "int8", topk_frac: float = 0.01
                             ) -> Tuple[Any, List[torch.Tensor]]:
    """Per-bucket compressed mean-reduction of a gradient tree.

    Each bucket is concatenated into one flat f32 vector (zero-padded to
    whole codec blocks), reduced across ``group`` through the selected
    codec with its own persistent residual, and scattered back to the
    original leaf shapes and dtypes (views of the reduced bucket where
    the dtype is float32).  ``residuals`` are not modified.

    Returns ``(reduced_tree, new_residuals)``; ``residuals`` must match
    ``plan`` (see ``init_residuals``), one row of this rank's own.
    """
    leaves = tree_leaves(tree)
    if len(residuals) != plan.num_buckets:
        raise ValueError(f"got {len(residuals)} residuals for "
                         f"{plan.num_buckets} buckets")
    new_leaves: List[Any] = [None] * len(leaves)
    new_residuals: List[torch.Tensor] = []
    for b, group_b in enumerate(plan.groups):
        reduced, new_err = _reduce_one(bucket_flat(leaves, plan, b),
                                       residuals[b], group, codec=codec,
                                       topk_frac=topk_frac)
        new_residuals.append(new_err)
        for i, x in bucket_leaves(reduced, leaves, plan, b):
            new_leaves[i] = x
    return unflatten(tree, new_leaves), new_residuals
