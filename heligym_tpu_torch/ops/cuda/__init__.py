"""Hand-written CUDA kernels of the port, their plain versions, and the
rollouts built on them."""
