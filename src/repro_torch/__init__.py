"""PyTorch/CUDA port of the dLLM serving tick (see README.md).

The JAX package ``repro`` is the unchanged reference; this package imports
nothing from it and nothing of JAX."""
