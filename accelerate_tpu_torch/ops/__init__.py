"""The port's kernels and their plain versions (``csrc/`` holds the CUDA sources)."""
