"""PyTorch/CUDA port of the wavefront path tracer in `lumenrenderer_tpu`.

Each module mirrors the file of the same path in the JAX package, which stays
the reference. This package imports torch and numpy only, never jax.
"""
