"""Tensor utilities and the hand-written aggregation kernels."""
