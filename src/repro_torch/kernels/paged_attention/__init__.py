from .ops import (paged_attention, paged_attention_append_chunk,
                  paged_attention_chunk, plan_splits)
from .ref import paged_attention_chunk_ref, paged_attention_ref
