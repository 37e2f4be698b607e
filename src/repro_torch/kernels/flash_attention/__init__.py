from .blockwise import blockwise_bwd, blockwise_fwd
from .ops import attention, attention_bwd, attention_fwd
from .ref import attention_ref
