"""Paper §4.4: Cannon's-algorithm matrix multiplication with overlap.

C = A x B on a ring of 8 ranks, every rank a slice of one stacked tensor on
the device: A row stripes stay put, B stripes rotate one step at a time by
ompx_put while the current block GEMM runs (the paper's 'additional block
stripe' trick).  Each block GEMM goes through
``repro_torch.kernels.ring_matmul.ops.matmul``: on the card one launch of
the hand-written matmul kernel per rank and step (f32 takes its CUDA-core
route), its plain version on the CPU.

Run:  PYTHONPATH=src python -m repro_torch.examples.cannon_matmul [N]
      [--device cpu] [--seed 0]

The check is the example's own: relative error < 1e-4 against A @ B in
f32 (TF32 off), computed on the same device.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..core.context import DiompContext, use_default
from ..core.groups import DiompGroup
from ..core.rma import ompx_put
from ..kernels.ring_matmul.ops import matmul
from ..launch.mesh import RankMesh

NDEV = 8


def cannon(a: torch.Tensor, b: torch.Tensor, g: DiompGroup) -> torch.Tensor:
    """Stacked ``a (n, ns, N)``: rank r's rows of A; ``b (n, ns, N)``: rank
    r's row stripe of B.  Returns the stacked row stripes of C.

    n steps: every rank multiplies the A block that meets the B stripe it
    holds, then puts that stripe onward around the ring (paper Listing-1
    style: put + fence folded into the stream's order).
    """
    n, ns = b.shape[0], b.shape[1]
    idx = torch.arange(n, device=a.device)
    blocks = a.view(n, ns, n, ns)
    acc = torch.zeros(a.shape[:2] + b.shape[2:], dtype=torch.float32,
                      device=a.device)
    stripe = b
    for s in range(n):
        src = (idx - s) % n                   # whose B stripe each rank holds
        a_block = blocks[idx, :, src]         # (n, ns, ns), each rank's block
        acc += matmul(a_block, stripe, impl="cuda").float()
        if s != n - 1:
            stripe = ompx_put(stripe, g, shift=1)   # overlaps the next GEMM
    return acc.to(a.dtype)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("N", nargs="?", type=int, default=768)
    ap.add_argument("--device", default="cuda",
                    help="where the ranks live (default: the card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    N = args.N
    if N % NDEV:
        raise SystemExit(f"N={N} must be a multiple of {NDEV}")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = RankMesh(("ring",), (NDEV,))
    ctx = DiompContext(mesh=mesh, device=args.device)
    dev = ctx.device
    g = DiompGroup(("ring",), name="ring")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    A = torch.randn(N, N, generator=gen, device=dev)
    B = torch.randn(N, N, generator=gen, device=dev)

    on_card = dev.type == "cuda"
    with use_default(ctx):
        if on_card:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            marks[0].record()
        t0 = time.perf_counter()
        C = cannon(A.view(NDEV, N // NDEV, N), B.view(NDEV, N // NDEV, N), g)
        if on_card:
            marks[1].record()
            marks[1].synchronize()
            ms = marks[0].elapsed_time(marks[1])
        else:
            ms = (time.perf_counter() - t0) * 1e3
    want = A @ B
    err = float((C.reshape(N, N) - want).abs().max() / want.abs().max())
    print(f"Cannon {N}x{N} on {NDEV} ranks ({dev}): {ms:.1f} ms, "
          f"rel err {err:.2e}")
    assert err < 1e-4, err
    print("cannon_matmul OK")
    return {"C": C, "err": err, "ms": ms}


if __name__ == "__main__":
    main()
