"""Hand-written CUDA kernels of the main path, each beside its plain
PyTorch version: ``frontend`` (kernel 1), ``coarse_fit`` (kernel 2),
``refine`` (kernel 3) and ``warp_decode`` (kernel 4)."""
