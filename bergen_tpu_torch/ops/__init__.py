"""Hand-written Hopper kernels (``csrc/``) with their plain PyTorch
versions, and the plain-PyTorch exact scoring path."""
