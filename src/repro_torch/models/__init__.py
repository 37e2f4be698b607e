"""The dense GQA decoder in PyTorch, with ParamSpec-declared parameters in
the reference's pytree layout: the training forward and loss, and the
paged-KV serve steps."""

from .config import ModelConfig
from .registry import ModelAPI, build_model
from .spec import ParamSpec, init_params
