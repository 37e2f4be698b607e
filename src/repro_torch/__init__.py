"""repro_torch — the PyTorch/CUDA port of ``repro``'s serving data plane.

The JAX package ``repro`` stays the reference; this package imports
``torch`` and numpy and nothing of ``repro`` or ``jax``.  Module paths and
function names mirror ``repro``'s (``repro_torch.models.attention.gqa_serve``
is the counterpart of ``repro.models.attention.gqa_serve``).

Entry points take an explicit ``device`` that defaults to ``"cuda"``; on a
machine without a card they raise unless the caller passes
``device="cpu"``.  The two TPU kernels of the serving path are CUDA C++ for
``sm_90a`` (``kernels/csrc``), built at first use; on CPU tensors their
plain PyTorch versions run instead.
"""
