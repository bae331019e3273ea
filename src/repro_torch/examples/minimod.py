"""Paper §4.5: Minimod — acoustic wave propagation with one-sided halos.

Thin CLI over the application (:mod:`repro_torch.apps.minimod`):
25-point acoustic stencil, 2-D (Z×Y) domain decomposition with optionally
asymmetric Z extents over heterogeneous ranks (PGAS asymmetric regions),
and three halo modes — ``none`` (two-sided, paper Listing 2), ``host``
(one-sided puts + fence, paper Listing 1) and ``fused`` (the one-sided
exchange overlapped with the interior stencil).

Run:  PYTHONPATH=src python -m repro_torch.examples.minimod
      [--shape minimod_hetero] [--mode fused] [--grid 64] [--steps 10]
      [--nz 8] [--ny 1] [--weights 3,2,2,1] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..apps.minimod import MODES, MinimodResult, run_minimod
from ..launch.shapes import STENCIL_SHAPES


def main(argv=None) -> MinimodResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=sorted(STENCIL_SHAPES), default=None,
                    help="a predefined Minimod cell (overrides grid/nz/ny)")
    ap.add_argument("--mode", choices=MODES, default="fused")
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--nz", type=int, default=8)
    ap.add_argument("--ny", type=int, default=1)
    ap.add_argument("--weights", type=str, default=None,
                    help="comma-separated per-rank Z proportions, e.g. 3,2,2,1")
    ap.add_argument("--device", default="cuda",
                    help="where the ranks live (default: the card)")
    args = ap.parse_args(argv)

    weights = tuple(float(w) for w in args.weights.split(",")) \
        if args.weights else None
    r = run_minimod(grid=(args.grid,) * 3, steps=args.steps, nz=args.nz,
                    ny=args.ny, weights=weights, mode=args.mode,
                    shape=args.shape, device=args.device)
    G = "x".join(str(g) for g in r.grid)
    print(f"minimod[{r.mode}]: grid {G}, {r.steps} steps on "
          f"{r.nz}x{r.ny} ranks ({r.field.device}) -> "
          f"{r.wall_s * 1e3:.1f} ms")
    print(f"  decomposition: z_extents={r.z_extents} "
          f"(PGAS region bytes/rank: {r.region_sizes})")
    print(f"  halo plan: overlap={r.plan.overlap} slots={r.plan.slots} "
          f"puts/step={r.plan.puts_per_step}")
    print(f"  wire audit: {r.puts} put call sites, {r.put_bytes} B on the "
          f"OMPCCL log; tracker windows {r.tracker_put_bytes} B, "
          f"{r.fences} fences")
    finite = bool(torch.isfinite(r.field).all())
    peak = float(r.field.abs().max())
    print(f"  wavefield energy {r.energy:.4e}, max |u| {peak:.3e} "
          f"(finite: {finite})")
    assert finite and peak > 0
    if r.mode == "fused":
        assert r.put_bytes == r.tracker_put_bytes, "put-traffic parity broken"
    print("minimod OK")
    return r


if __name__ == "__main__":
    main()
