"""The benchmark of the PyTorch and CUDA port (``pilosa_tpu_torch``)."""
