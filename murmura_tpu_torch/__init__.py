"""murmura_tpu_torch: the PyTorch/CUDA port of murmura_tpu.

A package of its own beside the JAX package, which stays the reference:
it imports ``torch`` (plus numpy, pydantic and yaml) and nothing of JAX or
of ``murmura_tpu``.  Entry point: ``python -m murmura_tpu_torch run <yaml>``.
"""
