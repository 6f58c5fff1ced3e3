"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  A wrapper runs the plain version for CPU tensors and launches
its kernel for CUDA tensors; it never falls back from one to the other."""
