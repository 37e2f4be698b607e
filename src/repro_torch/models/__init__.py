"""The dense GQA decoder's serve path in PyTorch, with ParamSpec-declared
parameters in the reference's pytree layout and paged-KV serve steps."""

from .config import ModelConfig
from .registry import ModelAPI, build_model
from .spec import ParamSpec, init_params
