"""Hand-written Hopper kernels (``csrc/``) and their wrappers:
``ops.flash_attention`` (forward and backward), ``ops.flash_decode``,
``ops.fused_ce`` and ``ops.ragged_matmul``.

Importing this package builds nothing: each wrapper compiles and loads its
kernel at its first CUDA call (``_build.load``).
"""
