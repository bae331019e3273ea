"""Quickstart: the port's DiOMP runtime in one tour.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Covers the paper's §3 machinery end to end on the 8-rank smoke mesh, every
rank a slice of one stacked tensor on the device: the unified runtime
(Fig. 1b), symmetric/asymmetric PGAS allocation (Fig. 2) with the
second-level pointer cache, DiOMP groups, one-sided put + fence and OMPCCL
collectives through one communicator handle, the analytic backend's
estimates and the call log.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.groups import DiompGroup, merge
from ..core.runtime import DiompRuntime
from ..interop import stack_shards, unstack_shards
from ..launch.mesh import make_smoke_mesh


def main(argv=None) -> DiompRuntime:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the ranks live (default: the card)")
    args = ap.parse_args(argv)

    mesh = make_smoke_mesh(8)
    rt = DiompRuntime(mesh, device=args.device, segment_bytes=1 << 24)
    ctx = rt.ctx           # the DiompContext: groups + memory + streams +
    #                        the OMPCCL communicator table, one object
    print("== unified runtime (paper Fig. 1b) ==")
    print(rt.report())

    # -- PGAS allocations: symmetric (offset-translated) + asymmetric
    #    (second-level pointer) — paper Fig. 2
    rt.register("weights/w1", (1024, 512), "bfloat16", ("embed_fsdp", "mlp"))
    rt.register("kv_pages", (8, 4096), "bfloat16", (None, None),
                symmetric=False, sizes=[4096 * (i + 1) for i in range(8)])
    w1 = rt.lookup("weights/w1")
    print(f"\nsymmetric region 'w1': remote addr on rank 5 = "
          f"{w1.region.remote_address(5)} (same offset on every rank)")
    kv = rt.lookup("kv_pages")
    print(f"asymmetric region 'kv': dereferenced via 2nd-level ptr -> "
          f"{rt.memory.translate(kv.region, 5)}  "
          f"(cache hit rate {rt.memory.ptr_cache.hit_rate:.0%})")
    rt.memory.translate(kv.region, 5)
    print(f"  after a second lookup: hit rate "
          f"{rt.memory.ptr_cache.hit_rate:.0%}")
    assert rt.memory.ptr_cache.hit_rate == 0.5

    # -- groups: split / merge (paper §3.3)
    world = rt.group("world")
    tp, rest = world.split("model")
    back = merge(rest, tp, name="recomposed")
    print(f"\ngroups: world={world.axes} -> split: tp={tp.axes} "
          f"rest={rest.axes} -> merge: {back.axes}")

    # -- one-sided RMA + OMPCCL collectives through ONE communicator handle:
    #    every op records against the context table and dispatches through
    #    the handle's backend (here the flat one)
    g = DiompGroup(("model",), name="tp")
    comm = ctx.communicator(g)
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    spec = (("pod", "data"), "model")
    xs = stack_shards(x, mesh, spec, device=rt.device)
    put = comm.fence(comm.put(xs, shift=1))        # one-sided put + fence
    red = comm.allreduce(xs)                       # ompx_allreduce
    bc = comm.bcast(xs, root=0)                    # ompx_bcast
    put, red, bc = (unstack_shards(t, mesh, spec) for t in (put, red, bc))
    print("\nompx_put(shift=1):\n", put)
    print("ompx_allreduce(tp):\n", red)
    print("ompx_bcast(root=0):\n", bc)
    # the model ring has two ranks, one column each
    assert (put == x[:, ::-1]).all()
    assert (red == np.repeat(x.sum(1, keepdims=True), 2, axis=1)).all()
    assert (bc == np.repeat(x[:, :1], 2, axis=1)).all()

    # backend choice is per-handle, and new backends plug in by name — the
    # analytic one logs a link-model cost estimate per collective
    acomm = ctx.communicator(g, backend="analytic")
    acomm.allreduce(xs)
    print("\nanalytic backend estimates:", acomm.backend.estimates)
    print("communicator call log:", ctx.stats())
    rt.fence()
    rt.close()
    print("\nquickstart OK")
    return rt


if __name__ == "__main__":
    main()
