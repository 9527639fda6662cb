"""Diagnostic scripts of the port, run by hand on a CUDA GPU."""
