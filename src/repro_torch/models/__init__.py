"""The decoder-only LMs (dense and MoE attention, Mamba2, the RG-LRU
hybrid) and the VLM backbone in PyTorch, with ParamSpec-declared
parameters in the reference's pytree layout: the training forward and
loss, and the chunked serve steps over paged KV pools or recurrent
state."""

from .config import ModelConfig
from .registry import ModelAPI, build_model
from .spec import ParamSpec, init_params
