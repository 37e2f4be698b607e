from .ops import kv_append, kv_append_chunk
from .ref import kv_append_chunk_ref, kv_append_ref
