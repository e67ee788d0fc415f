"""PyTorch port of blobstreamx_tpu for NVIDIA Hopper.

The JAX package (blobstreamx_tpu) is the reference; this package imports
nothing from it nor JAX. Entry points default to the card (device="cuda")
and raise without one unless device="cpu" is passed. The Pallas kernels of
the JAX package are CUDA kernels here (csrc/, built by kernels.py), each
with a plain PyTorch version that CPU tensors take.
"""
