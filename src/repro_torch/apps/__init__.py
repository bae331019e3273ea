"""Application drivers — the paper's workloads as programs owning their
decomposition, PGAS registration, schedules and audit trail."""

from .minimod import MinimodResult, run_minimod, split_extents  # noqa: F401
