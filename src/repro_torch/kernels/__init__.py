"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
twins (``ref``) and the wrappers, backend resolution and build (``ops``)."""

from . import ops, ref  # noqa: F401
