"""One-sided RMA — ``ompx_put`` / ``ompx_get`` / ``ompx_fence`` on stacked ranks.

The paper's RMA layer issues one-sided ``put``/``get`` over GASNet-EX into
the PGAS segment, with ``ompx_fence`` completing all outstanding operations
(§3.2).  With every rank on one card a put is a copy between the ranks'
slices of a stacked tensor: the wire lowerings live on the
:class:`~repro_torch.core.backends.CclBackend` classes, and this module is
the paper-verbatim free-function surface, dispatching through the active
:class:`~repro_torch.core.context.DiompContext` communicator handle.

* ``ompx_put(x, group, shift)`` — every rank deposits its shard into the
  window of the rank ``shift`` ahead; returns what landed in every window.
* ``ompx_get(x, group, shift)`` — fetch the shard of the rank ``shift``
  ahead (a read = a put with inverted permutation).
* ``halo_exchange(x, group)`` — the Minimod pattern (paper Listing 1).
* ``ompx_fence(*arrays)`` — completion/ordering point.

The host-side :class:`RMATracker` enforces the *programming model* (reads of
a window require a fence after the last put), so misuse fails loudly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

from .backends import fence as _fence
from .backends import payload_bytes
from .groups import DiompGroup

__all__ = [
    "ompx_put",
    "ompx_get",
    "ompx_put_perm",
    "ompx_fence",
    "halo_exchange",
    "halo_window_names",
    "dispatch_window_names",
    "attention_window_names",
    "validate_halo",
    "RMATracker",
    "RMAError",
]


class RMAError(RuntimeError):
    """Programming-model violation (read before fence, unknown window)."""


def _comm(group: DiompGroup, backend: str = None):
    # deferred: context imports RMATracker from this module at load time
    from .context import default_communicator

    return default_communicator(group, backend)


def ompx_put(x, group: DiompGroup, *, shift: int = 1, backend: str = None):
    """One-sided put of every rank's shard to the rank ``shift`` ahead.

    Every rank's window receives the shard of the rank ``shift`` *behind*
    it.  ``shift`` may be negative.
    """
    return _comm(group, backend).put(x, shift=shift)


def ompx_get(x, group: DiompGroup, *, shift: int = 1, backend: str = None):
    """One-sided get of the shard owned by the rank ``shift`` ahead."""
    return _comm(group, backend).get(x, shift=shift)


def ompx_put_perm(x, group: DiompGroup, perm: Sequence[Tuple[int, int]],
                  *, backend: str = None):
    """General one-sided put along an arbitrary (src, dst) permutation."""
    return _comm(group, backend).put_perm(x, perm)


def ompx_fence(*arrays):
    """Complete all outstanding RMA before anything downstream runs."""
    return _fence(*arrays)


def halo_window_names(group: DiompGroup, axis: int) -> Tuple[str, str]:
    """The (lo, hi) RMATracker window names of one halo-exchange pair."""
    return (f"halo:{group.name}:{axis}:lo", f"halo:{group.name}:{axis}:hi")


def dispatch_window_names(group: DiompGroup, ep: int
                          ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """The (dispatch, combine) RMATracker window names of one MoE dispatch.

    One window per ring offset ``s`` in each direction: ``dispatch:s`` is
    the landing window the put of step ``s`` fills (tokens from the rank
    ``s`` behind), ``combine:s`` the window the return put of step ``s``
    fills (my rows' expert outputs from the rank ``s`` ahead).  The fused
    MoE dispatch records every one-sided put against these windows with
    the bytes the OMPCCL communicator logs.
    """
    return (tuple(f"moe:{group.name}:dispatch:{s}" for s in range(1, ep)),
            tuple(f"moe:{group.name}:combine:{s}" for s in range(1, ep)))


def attention_window_names(group: DiompGroup, n: int,
                           direction: str = "bidi"
                           ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """The (cw, ccw) RMATracker window names of one ring-attention pass.

    Window ``dir:s`` is the landing window feeding step ``s``: the K/V
    stripe put at step ``s - 1`` lands there.  The clockwise stream serves
    the ring's left half (``n // 2`` windows on the bidirectional ring),
    the counter-clockwise stream the right half (``(n - 1) // 2``), as
    :meth:`~repro_torch.kernels.plan.RingPlan.schedule` sends.  The fused
    ring attention records every put (K and V separately) against these
    windows with the bytes the OMPCCL communicator logs.
    """
    if direction == "bidi":
        s_cw, s_ccw = n // 2, (n - 1) // 2
    elif direction == "cw":
        s_cw, s_ccw = n - 1, 0
    elif direction == "ccw":
        s_cw, s_ccw = 0, n - 1
    else:
        raise ValueError(f"unknown ring direction {direction!r}")
    return (tuple(f"attn:{group.name}:cw:{s}" for s in range(1, s_cw + 1)),
            tuple(f"attn:{group.name}:ccw:{s}" for s in range(1, s_ccw + 1)))


def validate_halo(halo: int, extent: int, axis: int) -> None:
    """Reject a halo the local shard cannot serve: a slab wider than the
    shard would wrap neighbor-of-neighbor data into the slab."""
    if halo < 1 or halo > extent:
        raise RMAError(
            f"halo_exchange(halo={halo}) invalid for local shard extent "
            f"{extent} along axis {axis}: the put would "
            + ("be empty" if halo < 1 else
               "wrap non-neighbor data into the slab")
            + " (shrink the halo or the rank count)")


def halo_exchange(x, group: DiompGroup, *, halo: int, axis: int = 0,
                  backend: str = None):
    """Minimod's halo pattern (paper Listing 1) as one fused exchange.

    ``x`` is stacked; ``axis`` is a local (per-rank) axis.  Returns
    ``(left_halo, right_halo)``; edge ranks receive zeros.  Each call is
    recorded against the active context's :class:`RMATracker`: two slab
    puts into the group's halo windows, one fence, then the reads.
    """
    from .context import default_context

    ctx = default_context()
    mesh = ctx.require_mesh()
    extent = x.shape[mesh.ndim + axis % (x.dim() - mesh.ndim)]
    validate_halo(halo, extent, axis)
    # a 1-rank ring exchanges nothing (both halos are the edge zeros):
    # record no puts — the audit trail reports only bytes on the wire
    if len(group.axes) == 1 and group.axis_size(mesh) == 1:
        return _comm(group, backend).halo_exchange(x, halo=halo, axis=axis)
    tracker = ctx.rma
    lo_w, hi_w = halo_window_names(group, axis)
    slab_bytes = payload_bytes(x, mesh.local_size) // extent * halo
    for w in (lo_w, hi_w):
        tracker.ensure(w)
        tracker.on_put(w, slab_bytes)
    out = _comm(group, backend).halo_exchange(x, halo=halo, axis=axis)
    tracker.on_fence(lo_w, hi_w)
    tracker.on_read(lo_w)
    tracker.on_read(hi_w)
    return out


# ---------------------------------------------------------------------------
# host-side programming-model tracker
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _WindowState:
    epoch: int = 0          # bumped by fence
    dirty_since: int = -1   # epoch of the last un-fenced put, -1 = clean
    checksum: str = None    # digest the last put claims to have landed


class RMATracker:
    """Host-side epoch tracker for put/fence discipline (tests + examples).

    Stream order makes every program correct by dataflow; this tracker exists
    to make the *programming model* of the paper checkable: reading a window that
    received a put since the last fence raises :class:`RMAError`, exactly the
    bug class ``ompx_fence`` exists to prevent on real hardware.
    """

    def __init__(self):
        self._windows: Dict[str, _WindowState] = {}
        self.puts = 0
        self.fences = 0
        self.put_bytes = 0
        self.window_bytes: Dict[str, int] = {}
        # re-issued wire traffic (fault retries) — accounted apart from the
        # logical counters above so byte-parity audits hold under chaos
        self.retry_puts = 0
        self.retry_bytes = 0
        self.window_retry_bytes: Dict[str, int] = {}

    def register(self, name: str) -> None:
        if name in self._windows:
            raise RMAError(f"window {name!r} already registered")
        self._windows[name] = _WindowState()

    def ensure(self, name: str) -> None:
        """Register ``name`` if it isn't yet (idempotent).

        Long-lived windows that persist across traces — the halo windows a
        stencil time loop puts into every step — are ensured at each call
        site instead of registered once at a setup point the trace may not
        own."""
        if name not in self._windows:
            self._windows[name] = _WindowState()

    def unregister(self, name: str) -> None:
        """Drop a window at the end of its allocation's lifetime (e.g. a
        serving request's KV window at release).  Its cumulative byte count
        survives in :attr:`window_bytes` for post-hoc accounting."""
        if self._windows.pop(name, None) is None:
            raise RMAError(f"unknown window {name!r}")

    def _state(self, name: str) -> _WindowState:
        try:
            return self._windows[name]
        except KeyError:
            raise RMAError(f"unknown window {name!r}") from None

    def on_put(self, name: str, nbytes: int = 0, *,
               checksum: str = None, retry: bool = False) -> None:
        """Record a put into ``name``.

        ``checksum`` is the digest the transfer claims to have landed
        (what :meth:`validate` checks after the fence); ``retry=True``
        marks a re-issued wire attempt, accounted in the retry counters
        instead of the logical put/byte log.
        """
        st = self._state(name)
        st.dirty_since = st.epoch
        st.checksum = checksum
        if retry:
            self.retry_puts += 1
            self.retry_bytes += nbytes
            if nbytes:
                self.window_retry_bytes[name] = \
                    self.window_retry_bytes.get(name, 0) + nbytes
            return
        self.puts += 1
        self.put_bytes += nbytes
        if nbytes:
            self.window_bytes[name] = self.window_bytes.get(name, 0) + nbytes

    def on_fence(self, *names: str) -> None:
        targets = names or tuple(self._windows)
        for name in targets:
            st = self._state(name)
            st.epoch += 1
            st.dirty_since = -1
        self.fences += 1

    def on_read(self, name: str) -> None:
        st = self._state(name)
        if st.dirty_since >= 0:
            raise RMAError(
                f"window {name!r} read with un-fenced puts outstanding "
                "(call ompx_fence first)"
            )

    def validate(self, name: str, checksum: str) -> None:
        """Check that the last fenced put landed ``checksum`` — the get-side
        integrity check that turns injected corruption into a detected,
        retryable error instead of silent bad data.  Reading an un-fenced
        window is the usual discipline violation; a digest mismatch after
        the fence raises :class:`RMAError` so the caller re-puts (accounted
        as retry traffic)."""
        st = self._state(name)
        if st.dirty_since >= 0:
            raise RMAError(
                f"window {name!r} validated with un-fenced puts outstanding "
                "(call ompx_fence first)"
            )
        if st.checksum != checksum:
            landed = (st.checksum or "<none>")[:12]
            raise RMAError(
                f"window {name!r} checksum mismatch: expected "
                f"{checksum[:12]}..., wire landed {landed}... "
                "(corrupted or dropped put)"
            )
