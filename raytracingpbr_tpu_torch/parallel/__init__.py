"""parallel of the PyTorch/CUDA port: inverse rendering (``train``)."""
