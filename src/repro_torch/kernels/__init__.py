"""Hand-written Hopper kernels.  Each kernel keeps its plain PyTorch version
beside it (``ref.py``), which its wrapper takes for CPU tensors only."""
