"""io of the PyTorch/CUDA port."""
