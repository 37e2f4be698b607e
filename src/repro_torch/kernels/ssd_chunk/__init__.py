from .ops import ssd_chunk, ssd_chunk_bwd, ssd_chunk_fwd
from .ref import ssd_chunk_bwd_plain, ssd_chunk_ref
from .tiled import ssd_chunk_bwd_tiled
