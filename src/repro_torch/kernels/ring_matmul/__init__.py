from .ops import matmul, ring_allgather_matmul  # noqa: F401
