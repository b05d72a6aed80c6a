"""Tensor operations: norms, activations, the SSM scan and conv, sampling."""
