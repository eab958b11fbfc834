"""Build and loading of the CUDA kernels in ../csrc (see build.py)."""
