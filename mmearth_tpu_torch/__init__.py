"""PyTorch/CUDA port of ``mmearth_tpu`` (MP-MAE pretraining on NVIDIA Hopper).

Imports ``torch`` and never ``jax`` or anything of ``mmearth_tpu``: the JAX
package stays the reference the port's tests compare against.  CUDA kernels
live in ``csrc/`` and are built at first use (``ops/_build.py``).
"""
