"""Hand-written Hopper kernels for the serving data plane, each beside its
plain PyTorch version (``ref.py``) and a wrapper that dispatches on the
tensor's device (``ops.py``; policy and build in ``common.py``)."""
from .common import LAUNCHES, reset_launch_counts
from .kv_append import (kv_append, kv_append_chunk, kv_append_chunk_ref,
                        kv_append_ref)
from .paged_attention import (paged_attention, paged_attention_chunk,
                              paged_attention_chunk_ref, paged_attention_ref)
