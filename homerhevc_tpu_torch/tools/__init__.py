"""Measurement scripts of the torch port (run on a CUDA card)."""
