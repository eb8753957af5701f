"""The benchmark of the PyTorch and CUDA port, rlshaders_tpu_torch."""
