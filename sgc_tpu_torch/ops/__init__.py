"""SpMM operators, their CUDA kernels and plain versions."""
