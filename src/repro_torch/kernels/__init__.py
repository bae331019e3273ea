"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions,
their emulations and the planner that schedules them."""
