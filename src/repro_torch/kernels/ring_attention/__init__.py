"""Sequence-parallel ring attention: the merge monoid, the plain version,
the CUDA kernel with its emulation, and the public op."""

from .kernel import (empty_state, finalize_state, merge_states,  # noqa: F401
                     scaled_queries, stripe_mask, stripe_state)
from .ops import resolve_attention_impl, ring_attention  # noqa: F401
from .ref import ring_attention_ref  # noqa: F401
