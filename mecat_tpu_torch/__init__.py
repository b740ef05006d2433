"""mecat_tpu_torch: the PyTorch + CUDA port of mecat_tpu.

A second package beside mecat_tpu with the same module paths and function
names.  It imports neither JAX nor mecat_tpu (whose package init configures
JAX): the machine with the GPU has no JAX.  The host layer it needs
(constants, io, utils) is copied here, its hot paths in the native C++
layer of ``native/`` (built with ``g++`` at first use).  The Hopper DP
kernels are built and loaded at their first CUDA call, never at import.
"""

__version__ = "0.1.0"
