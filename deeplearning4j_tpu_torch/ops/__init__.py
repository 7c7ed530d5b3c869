"""Hand-written Hopper kernels and their plain PyTorch versions.

``flash_attention`` is the layers' entry point (``ops/attention.py``),
resolved at first use; nothing here builds a kernel (builds run at a
kernel's first launch, ``ops/native.py``)."""

from deeplearning4j_tpu_torch import _lazy

__all__ = ["flash_attention"]

__getattr__ = _lazy.exports(__name__, {"flash_attention": "attention"})
