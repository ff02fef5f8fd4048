"""The benchmark of the PyTorch/CUDA port (``repro_torch``): open-loop
serving cells on one H100, driven by the files under this folder."""
