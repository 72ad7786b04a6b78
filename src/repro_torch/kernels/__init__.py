"""The port's kernels: hand-written CUDA for Hopper, each beside its plain
PyTorch version. Importing this package builds and loads nothing."""
