"""Pallas kernels for the GPU (Triton route); tests run them in
interpret mode."""
