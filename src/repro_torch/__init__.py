"""PyTorch/CUDA port of the ``repro`` package (MINIMALIST minGRU serving).

The JAX package ``repro`` stays the reference; this package mirrors its
layout module for module and imports nothing of it, nor JAX."""
