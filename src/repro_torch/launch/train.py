"""Training launcher: the reference's ``repro.launch.train`` on the port.

It wires the DiOMP substrate together: the runtime's PGAS registration of
every parameter, the synthetic data pipeline with async prefetch, the
train step (explicit OMPCCL gradient reduction in buckets), atomic
checkpoints with verify, auto-resume and elastic re-shard, and the
straggler monitor with a CLOSED eviction loop: when the monitor escalates
on step-time outliers, the launcher checkpoints, shrinks the mesh to half
its ranks, restores from the latest verified checkpoint and trains on.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --reduced --steps 30 --batch 8 --seq 64 --device cpu

The flags and defaults are the reference's, plus ``--device`` (the card
unless ``--device cpu``), ``--seed`` (the random weights) and mesh shapes
given as ``--mesh data=2,model=2``; ``--mesh smoke`` is the 8-rank
pod x data x model mesh; ``--layout dp_only`` (no tensor parallelism: the
batch over every axis, the weights replicated over "model") beside the
default ``tp``.  Every architecture trains on the pipeline's batches of
its family: hubert-xlarge on audio frames, targets and a frame mask, the
frames laid out in the batch's bf16.  ``--chaos-seed`` runs the step under
a seeded ``FaultPlan`` (drop, fail and timeout faults with probability
``--chaos-p`` a dispatch, each retried: the run's numbers equal the calm
run's); with it, ``--kill-rank-step`` kills the mesh's last rank at that
step, and the straggler monitor's escalation starts the elastic restore.
``main`` returns a summary of the run (losses, grad norms, step times, the
final parameters and optimizer state).
"""

from __future__ import annotations

import argparse
import time

import torch

from .. import configs
from ..core.context import DiompContext, resolve_device, use_default
from ..core.faults import FaultPlan
from ..core.runtime import DiompRuntime, dtype_bytes
from ..distributed.sharding import param_bytes_per_device, rules_for_ctx
from ..data.pipeline import Prefetcher, SyntheticLM
from ..interop import stack_shards, unstack_shards
from ..launch.mesh import RankMesh, make_production_mesh, make_smoke_mesh
from ..models import api as model_api
from ..models import schema as sch
from ..models.config import ParallelCtx
from ..train.checkpoint import CheckpointManager
from ..train.optim import (adafactor, adafactor_dim_axes, adamw,
                           cosine_schedule)
from ..train.step import build_train_step, opt_state_specs
from ..train.straggler import StragglerMonitor

__all__ = ["main", "parse_mesh", "to_global", "from_global"]


def parse_mesh(text: str) -> RankMesh:
    """``"smoke"``, ``"production"`` or ``"axis=size,..."``."""
    if text == "smoke":
        return make_smoke_mesh(8)
    if text == "production":
        return make_production_mesh(multi_pod=True)
    axes, sizes = zip(*(part.split("=") for part in text.split(",")))
    return RankMesh(tuple(a.strip() for a in axes),
                    tuple(int(s) for s in sizes))


def _tree_map(fn, tree, specs, prefix=""):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, specs[k], f"{prefix}{k}|")
                for k, v in tree.items()}
    return fn(tree, specs)


def to_global(tree, specs, mesh: RankMesh):
    """Stacked tensors -> global CPU tensors in their own dtype (what a
    checkpoint stores)."""
    def one(t, spec):
        if t.dtype == torch.bfloat16:
            return torch.from_numpy(unstack_shards(t, mesh, spec)).to(
                torch.bfloat16)
        return torch.from_numpy(unstack_shards(t, mesh, spec))
    return _tree_map(one, tree, specs)


def from_global(tree, specs, mesh: RankMesh, device):
    """Global tensors -> stacked tensors on ``mesh`` (the elastic
    re-shard of a restore)."""
    return _tree_map(lambda t, spec: stack_shards(t, mesh, spec,
                                                  device=device,
                                                  dtype=t.dtype),
                     tree, specs)


def _batch_on(batch, structs, specs, mesh, device):
    """A pipeline batch stacked on ``mesh``, each leaf in the dtype
    ``batch_structs`` gives it."""
    return {k: stack_shards(v, mesh, specs[k], device=device,
                            dtype=structs[k].dtype)
            for k, v in batch.items()}


def main(argv=None, cfg=None):
    """Run the flags' training; ``cfg``, where given, is the model config
    in place of ``--arch``'s (a depth cut, say)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b",
                    choices=configs.all_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--mesh", default="smoke",
                    help="smoke, production, or axis=size,... (e.g. "
                         "data=2,model=2)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--layout", default="tp", choices=["tp", "dp_only"])
    ap.add_argument("--grad-codec", default="none", choices=["none", "int8"])
    ap.add_argument("--dp-backend", default="hierarchical",
                    choices=["flat", "hierarchical"])
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="enable deterministic fault injection (FaultPlan)")
    ap.add_argument("--chaos-p", type=float, default=0.05,
                    help="per-dispatch fault probability under --chaos-seed")
    ap.add_argument("--kill-rank-step", type=int, default=None,
                    help="schedule a rank death at this step (elastic "
                         "restore exercise; needs --chaos-seed and "
                         "--checkpoint-dir)")
    ap.add_argument("--max-restarts", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="where the step runs (the card by default)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if cfg is None:
        cfg = configs.get_reduced(args.arch) if args.reduced \
            else configs.get(args.arch)
    mesh = parse_mesh(args.mesh)
    fault_plan = None
    if args.chaos_seed is not None:
        fault_plan = FaultPlan(args.chaos_seed, p=args.chaos_p,
                               kinds=("drop", "fail", "timeout"))
        if args.kill_rank_step is not None:
            fault_plan.kill_rank(args.kill_rank_step, rank=mesh.size - 1)

    def make_ctx(mesh):
        return ParallelCtx.from_mesh(
            mesh, remat=True, microbatch=args.microbatch,
            grad_codec=args.grad_codec, dp_backend=args.dp_backend,
            layout=args.layout)

    ctx = make_ctx(mesh)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"mesh={mesh.shape} layout={args.layout} dp={ctx.dp} tp={ctx.tp} "
          f"device={device}")

    # -- runtime: register every parameter into the PGAS plan -------------
    # (a segment of 1 GiB, as in the reference, or the power of two that
    # holds twice a rank's parameters at full width)
    schema = sch.build_schema(cfg)
    per_rank = sum(param_bytes_per_device(spec.shape, dtype_bytes(spec.dtype),
                                          spec.axes, mesh)
                   for spec in schema.values())
    segment = max(1 << 30, 1 << (2 * per_rank - 1).bit_length())
    rt = DiompRuntime(mesh, context=DiompContext(
        mesh=mesh, device=device, segment_bytes=segment,
        fault_plan=fault_plan))
    for name, spec in schema.items():
        rt.register(name, spec.shape, spec.dtype, spec.axes)
    print(f"PGAS plan: {rt.bytes_in_use()/2**20:.1f} MiB/device in "
          f"{len(rt.table())} regions")

    # -- optimizer + step -------------------------------------------------------
    lr = cosine_schedule(args.lr, warmup=max(args.steps // 10, 1),
                         total=args.steps)
    if cfg.param_count() >= 30e9:
        opt, opt_name = adafactor(lr, dim_axes=adafactor_dim_axes(cfg, mesh),
                                  nd=mesh.ndim), "adafactor"
    else:
        opt, opt_name = adamw(lr), "adamw"

    def build_step(mesh, ctx, dctx):
        # the loop never reuses a step's inputs: donate them, so the
        # update runs in place (the reference passes donate=False to its
        # jit; the port's copies would hold a second optimizer state);
        # the step's plans resolve through dctx's planner
        with use_default(dctx):
            return build_train_step(cfg, mesh, ctx, opt,
                                    optimizer_name=opt_name, donate=True)

    def specs_for(mesh):
        bstructs, bspecs = model_api.batch_structs(
            cfg, mesh, args.batch, args.seq, dp_axes=ctx.dp_axes)
        rules = rules_for_ctx(ctx)
        return (sch.partition_specs(cfg, mesh, rules),
                opt_state_specs(cfg, mesh, opt_name, rules), bstructs,
                bspecs)

    dctx = rt.ctx
    step_fn = build_step(mesh, ctx, dctx)
    pspecs, ospecs, bstructs, bspecs = specs_for(mesh)

    # -- init or resume ---------------------------------------------------------
    ckpt = CheckpointManager(args.checkpoint_dir, pool=rt.streams) \
        if args.checkpoint_dir else None
    start = 0
    if ckpt and args.resume and ckpt.latest() is not None:
        start, params, opt_state, _ = ckpt.restore()
        params = from_global(params, pspecs, mesh, device)
        opt_state = from_global(opt_state, ospecs, mesh, device)
        print(f"resumed from step {start}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = sch.init_params(cfg, mesh, gen, device=device,
                                 rules=rules_for_ctx(ctx))
        opt_state = opt.init(params)

    # -- data + monitoring ------------------------------------------------------
    source = SyntheticLM(cfg, args.batch, args.seq, seed=17)
    prefetch = Prefetcher(source, depth=2, pool=rt.streams, start_step=start)
    evict_flag = {"requested": False}
    monitor = StragglerMonitor(
        on_prefetch_boost=lambda n: prefetch.boost(1),
        on_evict=lambda: evict_flag.update(requested=True))

    def save(step_no, params, opt_state, blocking=False):
        ckpt.save(step_no, to_global(params, pspecs, mesh),
                  to_global(opt_state, ospecs, mesh), blocking=blocking)

    # -- the loop -------------------------------------------------------------------
    losses, norms, step_s = [], [], []
    t_start = time.time()
    restarts = 0
    end = start + args.steps
    i = start
    loss = float("nan")
    while i < end:
        monitor.step_start()
        t0 = time.perf_counter()
        _, batch = prefetch.get()
        batch = _batch_on(batch, bstructs, bspecs, mesh, device)
        with use_default(dctx):
            params, opt_state, metrics = step_fn(params, opt_state, batch, i)
        loss = float(metrics["loss"].reshape(-1)[0])
        gnorm = float(metrics["grad_norm"].reshape(-1)[0])
        step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        norms.append(gnorm)
        if fault_plan is not None and fault_plan.deaths_at(i):
            monitor.escalate(i, "rank-death")
        else:
            monitor.step_end(i)
        if i % 5 == 0 or i == end - 1:
            print(f"step {i:5d}  loss {loss:.4f}  gnorm {gnorm:.3f}  "
                  f"({(time.time()-t_start)/max(i-start+1,1):.2f}s/step)")
        if ckpt and (i + 1) % args.checkpoint_every == 0:
            save(i + 1, params, opt_state)
        i += 1
        if evict_flag["requested"]:
            evict_flag["requested"] = False
            if ckpt is None or restarts >= args.max_restarts \
                    or mesh.size <= 2:
                print(f"[elastic] eviction at step {i} but no restart "
                      "possible (need --checkpoint-dir, restart budget, "
                      ">2 ranks); continuing degraded")
                continue
            # elastic restore: persist, shrink to half the ranks, resume
            # from the latest VERIFIED checkpoint on the new mesh
            ckpt.wait()
            if ckpt.latest() is None:
                save(i, params, opt_state, blocking=True)
            mesh = make_smoke_mesh(max(mesh.size // 2, 2))
            ctx = make_ctx(mesh)
            # the same plan and policy: the run keeps injecting, and the
            # death, already fired, does not fire again
            dctx = DiompContext(mesh=mesh, device=device,
                                segment_bytes=1 << 30,
                                fault_plan=dctx.fault_plan,
                                retry_policy=dctx.retry_policy)
            step_fn = build_step(mesh, ctx, dctx)
            pspecs, ospecs, bstructs, bspecs = specs_for(mesh)
            i, params, opt_state, _ = ckpt.restore()
            params = from_global(params, pspecs, mesh, device)
            opt_state = from_global(opt_state, ospecs, mesh, device)
            prefetch = Prefetcher(source, depth=2, pool=rt.streams,
                                  start_step=i)
            monitor.reset()
            restarts += 1
            print(f"[elastic] restart {restarts}: resumed step {i} on "
                  f"{mesh.size} ranks (mesh {mesh.shape})")
    if ckpt:
        ckpt.wait()
        print(f"checkpoints: steps {ckpt.steps()}")
    if monitor.events:
        print(f"straggler events: "
              f"{[(e.step, e.action) for e in monitor.events]}")
    if restarts:
        print(f"elastic restarts: {restarts}")
    rt.close()
    print("train launcher done")
    return {"loss": loss, "losses": losses, "grad_norms": norms,
            "step_s": step_s, "params": params, "opt_state": opt_state,
            "mesh": mesh, "restarts": restarts, "context": dctx}


if __name__ == "__main__":
    main()
