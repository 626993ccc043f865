"""Kernels and passes of the free-running CGGibbs engine."""
