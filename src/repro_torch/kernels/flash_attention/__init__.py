"""Flash attention: the plain version, the CUDA kernel and the public op."""
