"""Tensor operations. Counterpart of ``paddle_tpu/tensor_ops`` (only
``matmul`` so far: the product amp casts in the tied LM heads)."""
from .math import matmul

__all__ = ["matmul"]
