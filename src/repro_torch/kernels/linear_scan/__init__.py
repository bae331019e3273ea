"""The unified linear-recurrence scan: the plain version, the CUDA kernel
and the public op."""

from .ops import linear_scan  # noqa: F401
