"""Hand-written Hopper kernels of the port (CUDA C++, built by ``_build``)."""
