"""Hand-written Hopper kernels for the serving and training paths, each
beside its plain PyTorch version (``ref.py``, ``blockwise.py``) and a
wrapper that dispatches on the tensor's device (``ops.py``; policy and
build in ``common.py``)."""
from .common import LAUNCHES, reset_launch_counts
from .flash_attention import (attention, attention_bwd, attention_fwd,
                              attention_ref,
                              blockwise_bwd, blockwise_fwd)
from .kv_append import (kv_append, kv_append_chunk, kv_append_chunk_ref,
                        kv_append_ref)
from .paged_attention import (paged_attention, paged_attention_append_chunk,
                              paged_attention_chunk,
                              paged_attention_chunk_ref, paged_attention_ref)
from .ssd_chunk import (ssd_chunk, ssd_chunk_bwd, ssd_chunk_bwd_plain,
                        ssd_chunk_bwd_tiled, ssd_chunk_fwd, ssd_chunk_ref)
