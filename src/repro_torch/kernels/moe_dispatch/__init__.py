"""Dropless MoE dispatch: the plain versions, the two CUDA kernels (expert
MLP, fused dispatch) and the public op."""
from .ops import moe_dispatch  # noqa: F401
from .ref import measure_expert_load, moe_ref, route_topk  # noqa: F401
