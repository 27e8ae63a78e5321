"""Hand-written Hopper kernels (``csrc/``) and their wrappers:
``ops.flash_attention`` (forward and backward), ``ops.flash_decode``,
``ops.fused_ce``, ``ops.ragged_matmul``, ``ops.int8_matmul`` and
``ops.stochastic_round``.

Importing this package builds nothing: each wrapper compiles and loads its
kernel at its first CUDA call (``_build.load``).
"""
