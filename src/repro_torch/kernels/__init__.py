"""Hand-written Hopper kernels. Each kernel follows the JAX package's layout:
``<name>/kernel.py`` (launch) with its CUDA source under ``<name>/csrc/``,
``ops.py`` (the differentiable op) and ``ref.py`` (the plain version)."""
