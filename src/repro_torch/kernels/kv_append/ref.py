"""Plain PyTorch versions of the KV append scatter, written from
``repro/kernels/kv_append/ref.py``.

Same contract as the reference, with one difference the port makes on
purpose: the pool is updated IN PLACE (``index_put_``) and returned, where
the JAX oracle returns a new array.  Duplicate (page, slot) pairs of pad
tokens may only hit the null page 0, where any write order is acceptable.
"""

from __future__ import annotations

import torch


def kv_append_ref(pool: torch.Tensor,        # [P, T, KV, D]
                  new: torch.Tensor,         # [B, KV, D]
                  page_ids: torch.Tensor,    # [B] int32
                  slot_ids: torch.Tensor,    # [B] int32
                  ) -> torch.Tensor:
    """new[b] lands at pool[page_ids[b], slot_ids[b]] (one token per
    sequence: the decode slice)."""
    pool[page_ids.long(), slot_ids.long()] = new.to(pool.dtype)
    return pool


def kv_append_chunk_ref(pool: torch.Tensor,        # [P, T, KV, D]
                        new: torch.Tensor,         # [B, C, KV, D]
                        page_ids: torch.Tensor,    # [B, C] int32
                        slot_ids: torch.Tensor,    # [B, C] int32
                        ) -> torch.Tensor:
    """new[b, c] lands at pool[page_ids[b, c], slot_ids[b, c]]."""
    pool[page_ids.long(), slot_ids.long()] = new.to(pool.dtype)
    return pool
