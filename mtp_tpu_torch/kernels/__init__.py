"""CUDA kernel build and loading (see `_build.py`)."""
