"""The dense GQA decoder and Mamba2 in PyTorch, with ParamSpec-declared
parameters in the reference's pytree layout: the training forward and
loss, and the chunked serve steps over paged KV pools or SSM state."""

from .config import ModelConfig
from .registry import ModelAPI, build_model
from .spec import ParamSpec, init_params
