"""PyTorch/CUDA port of ``dair_pll_tpu``: differentiable contact-dynamics
learning on NVIDIA GPUs.

The JAX package stays the reference; every module here mirrors the JAX
module of the same path and name. This package imports ``torch`` and
never ``jax``, and nothing of ``dair_pll_tpu``.
"""
