"""Hand-written Hopper kernels (``csrc/``), each with a plain PyTorch
version beside it (``ref.py``) and a wrapper (``ops.py``) that pads and
checks its operands, then launches the kernel on CUDA tensors and runs the
plain version on CPU tensors."""
