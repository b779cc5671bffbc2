"""PyTorch / CUDA port of ``newsreclib_tpu`` for NVIDIA Hopper (H100).

Module names mirror the JAX package so each piece has an obvious
counterpart.  The port imports ``torch`` and numpy only; the JAX package
stays the numerical reference and is imported by the port's tests alone.
"""
