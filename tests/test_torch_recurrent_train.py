"""The recurrent families' training held against the JAX package's.

Reduced rwkv6-7b (the linear scan under readout_pre, RWKV's log-decay
``-exp(w_log)``) and zamba2-1.2b (Mamba2's post-readout scan with its
decay broadcast over the state dim, and the shared attention block) on
the 8-rank smoke mesh: ``rwkv_loss`` / ``zamba_loss`` and every gradient
leaf against ``jax.value_and_grad`` of the reference's losses in a
test-built ``shard_map`` (``tests/test_torch_train.py``'s ``_reference``,
on the same numpy weights and batch).  f32: loss 1e-5 relative and
gradients 1e-4 of each leaf's largest value (that file's tolerances).
bf16: loss 1e-3, and each gradient leaf within 2e-2 of its largest value
(that file's bound) or, where the reference's own bf16 gradient lies
further than that from its f32 one, within that distance: reduced rwkv6's
time-mix leaves (the decay's LoRA, w0, the key and receptance
projections) differ by up to 0.11 of their scale between the reference's
bf16 and f32 runs, and the port's bf16 gradients lie within 0.064 of the
reference's bf16 ones.  Each layer (and each shared-block application)
is checkpointed under ``ctx.remat``; its recompute logs nothing, as the
reference traces its checkpointed functions once.  The launcher trains
both families on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.context import DiompContext, use_default
from repro_torch.interop import unstack_shards
from repro_torch.models import api, schema
from repro_torch.models.config import ParallelCtx
from repro_torch.train.step import per_rank_grads, reduce_gradients

from test_torch_train import (DTYPES, MESH, _port_batch, _port_params,
                              _reference)

ARCHS = ("rwkv6-7b", "zamba2-1-2b")


def _port_grads(arch, dt, jp, **knobs):
    cfg, tp = _port_params(arch, dt, jp)
    ctx = ParallelCtx.from_mesh(MESH, **{"remat": True, **knobs})
    with use_default(DiompContext(mesh=MESH, device="cpu")):
        loss, grads = per_rank_grads(tp, _port_batch(cfg, dt, ctx), cfg, ctx,
                                     MESH)
        red, _ = reduce_gradients(grads, cfg, ctx, mesh=MESH)
    specs = schema.partition_specs(cfg, MESH)
    return float(loss.mean()), {n: unstack_shards(g, MESH, specs[n])
                                for n, g in red.items()}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, dt, mesh8):
    jp, jloss, jgrads = _reference(arch, dt, mesh8)
    loss, grads = _port_grads(arch, dt, jp)
    _, ltol, gtol = DTYPES[dt][1:]
    assert abs(loss - jloss) <= ltol * abs(jloss)
    assert sorted(grads) == sorted(jgrads)
    f32 = _reference(arch, "f32", mesh8)[2] if dt == "bf16" else None
    for n, want in jgrads.items():
        bound = gtol * max(np.abs(want).max(), 1e-30)
        if f32 is not None:     # the reference's own bf16 error, where larger
            bound = max(bound, np.abs(want - f32[n]).max())
        assert np.abs(grads[n] - want).max() <= bound, n


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_the_plain_forward(arch, mesh8):
    """Checkpointing each block changes no gradient: ``remat=False``
    against ``remat=True`` within f32 rounding (1e-6 of each leaf)."""
    jp, _, _ = _reference(arch, "f32", mesh8)
    l1, g1 = _port_grads(arch, "f32", jp)
    l0, g0 = _port_grads(arch, "f32", jp, remat=False)
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for n in g0:
        assert np.abs(g1[n] - g0[n]).max() <= 1e-6 * max(
            np.abs(g0[n]).max(), 1e-30), n


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recompute_logs_against_the_forward_context(arch, mesh8):
    """The backward, with every checkpointed block's recompute, runs in
    another thread while the process default is a context of another
    mesh: it runs on the forward's mesh, logs nothing, and the gradients
    arrive for every leaf."""
    import threading

    from repro_torch.core.context import install_default, reset_default_context
    from repro_torch.launch.mesh import RankMesh

    jp, jloss, _ = _reference(arch, "f32", mesh8)
    cfg, tp = _port_params(arch, "f32", jp)
    ctx = ParallelCtx.from_mesh(MESH, remat=True)
    other = install_default(DiompContext(mesh=RankMesh(("x",), (8,)),
                                         device="cpu"))
    try:
        names = sorted(tp)
        leaves = {n: tp[n].detach().requires_grad_(True) for n in names}
        dc = DiompContext(mesh=MESH, device="cpu")
        with use_default(dc):
            loss = api.loss_fn(cfg)(leaves, _port_batch(cfg, "f32", ctx),
                                    cfg, ctx)
        logged = dc.stats()
        assert sum(sum(v.values()) for v in logged.values()) > 0
        out = {}

        def backward():
            try:
                out["grads"] = torch.autograd.grad(
                    loss.sum(), [leaves[n] for n in names])
            except Exception as exc:  # noqa: BLE001 - reported below
                out["error"] = exc

        t = threading.Thread(target=backward)
        t.start()
        t.join()
        assert "error" not in out, out.get("error")
        assert len(out["grads"]) == len(names)
        assert dc.stats() == logged and other.stats() == {}
        assert abs(float(loss.detach().mean()) - jloss) <= 1e-5 * abs(jloss)
    finally:
        reset_default_context()


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_on_the_cpu(arch):
    """``launch.train --arch <recurrent> --reduced --device cpu``: finite
    losses and gradient norms on the 8-rank mesh."""
    from repro_torch.core.context import reset_default_context
    from repro_torch.launch import train as launcher

    try:
        run = launcher.main(["--arch", arch, "--reduced", "--steps", "2",
                             "--batch", "8", "--seq", "16", "--device",
                             "cpu"])
    finally:
        reset_default_context()
    assert len(run["losses"]) == 2
    assert np.isfinite(run["losses"]).all()
    assert np.isfinite(run["grad_norms"]).all()
