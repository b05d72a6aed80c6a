"""Utilities of the port: vocabulary, profiling and checkpoints."""
