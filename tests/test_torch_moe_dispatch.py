"""The port's dropless MoE dispatch held against the JAX package's.

The reference's cases (``tests/test_moe_fused.py``) run through both
packages on the same inputs, made from a seed with numpy: the reference in
``shard_map`` on the 8-device CPU mesh with its Pallas kernels in
interpret mode or through its plain paths, the port on stacked ranks on
the CPU, where each kernel wrapper runs its plain version.

* The planner: ``AllToAllPlan.schedule()`` record for record, and
  ``plan_alltoall``'s caps, slots and sizes for measured, slack, zero-load
  and unmeasured routing; at qwen3-moe's full width the port's plan keeps
  ``overlap=True`` where the reference's VMEM formula serializes.
* The expert MLP's plain version against ``expert_mlp_pallas`` (interpret)
  and ``expert_mlp_ref``: within 1e-5 of the output's scale in f32 (both
  sum in f32, in another order); a zero row maps to a zero row.
* The dispatch: ``dispatch_buffers`` equal; ``moe_dispatch`` fused and
  host within 1e-5 of the reference's (f32) under imbalanced routing; the
  port's fused output equal to its own ``moe_ref`` bit for bit (dropless
  dispatch only moves data); an undersized plan's drop count equal to the
  reference's; call, byte and RMA window logs equal.

Routing (``route_topk``) must give the reference's expert indices exactly;
``torch.topk`` and ``lax.top_k`` agree except where two probabilities tie
exactly, which these random f32 inputs do not produce.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.core.compat import make_mesh, shard_map
from repro.core.context import DiompContext as JContext
from repro.core.context import default_context as j_default_context
from repro.core.context import use_default as j_use_default
from repro.core.groups import DiompGroup as JGroup
from repro.kernels import plan as j_plan
from repro.kernels.moe_dispatch import fused as j_fused
from repro.kernels.moe_dispatch import kernel as j_kernel
from repro.kernels.moe_dispatch import ref as j_ref
from repro.kernels.moe_dispatch.ops import moe_dispatch as j_moe_dispatch

from repro_torch.core.context import DiompContext, use_default
from repro_torch.core.groups import DiompGroup
from repro_torch.core.rma import dispatch_window_names
from repro_torch.interop import stack_shards, unstack_shards
from repro_torch.kernels import plan
from repro_torch.kernels.moe_dispatch import (measure_expert_load,
                                              moe_dispatch, moe_ref,
                                              route_topk)
from repro_torch.kernels.moe_dispatch.fused import (dispatch_buffers,
                                                    fused_moe_dispatch_kernel,
                                                    kernel_slots)
from repro_torch.kernels.moe_dispatch.kernel import (expert_mlp,
                                                     expert_mlp_plain)
from repro_torch.kernels.moe_dispatch.ref import expert_mlp_ref
from repro_torch.launch.mesh import RankMesh

GROUP, JGROUP = DiompGroup(("x",), name="epx"), JGroup(("x",), name="epx")


def _planners():
    return plan.OverlapPlanner(), j_plan.OverlapPlanner()


def _same_plan(mine, ref):
    for field in ("ep", "E", "t_loc", "k", "d", "itemsize", "caps", "slots",
                  "overlap"):
        assert getattr(mine, field) == getattr(ref, field), field
    for prop in ("E_loc", "cap_pad", "block_bytes", "region_rows",
                 "wire_bytes", "staging_bytes"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert [mine.block_rows(r) for r in range(mine.ep)] == \
        [ref.block_rows(r) for r in range(ref.ep)]
    assert mine.schedule() == ref.schedule()


# -- the planner ----------------------------------------------------------------

@pytest.mark.parametrize("ep", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("overlap", [True, False])
def test_schedule_equals_reference(ep, overlap):
    kw = dict(ep=ep, E=8 * ep, t_loc=8, k=2, d=16, caps=(2,) * (8 * ep),
              overlap=overlap)
    assert plan.AllToAllPlan(**kw).schedule() == \
        j_plan.AllToAllPlan(**kw).schedule()


@pytest.mark.parametrize("case", ["measured", "slack", "zero_load", "none",
                                  "ep8", "host"])
def test_plan_alltoall_equals_reference(case):
    loads = (6, 5, 8, 6, 7, 6, 3, 5)
    args, kw = (16, 32, 2, 8, 4), {}
    if case in ("measured", "host"):
        kw = dict(loads=loads, overlap=case == "measured")
    elif case == "slack":
        kw = dict(loads=loads, slack=1.5)
    elif case == "zero_load":
        args, kw = (32, 16, 2, 8, 4), dict(loads=(32,) + (0,) * 7)
    elif case == "ep8":
        args = (12, 16, 2, 16, 8)
    mine, ref = _planners()
    _same_plan(mine.plan_alltoall(*args, torch.float32, **kw),
               ref.plan_alltoall(*args, jnp.float32, **kw))


def test_plan_validation():
    mine, _ = _planners()
    with pytest.raises(ValueError):
        mine.plan_alltoall(16, 32, 2, 6, 4, torch.float32)
    with pytest.raises(ValueError):
        plan.AllToAllPlan(ep=4, E=8, t_loc=8, k=2, d=16, caps=(2,) * 7)
    with pytest.raises(ValueError):
        plan.AllToAllPlan(ep=4, E=8, t_loc=8, k=2, d=16, caps=(0,) * 8)


@pytest.mark.parametrize("t_loc", [2, 256], ids=["decode", "chunk"])
def test_full_width_plan_keeps_overlap(t_loc):
    """qwen3-moe on two EP ranks: a decode block is 1 MiB and a 512-token
    chunk's 128 MiB.  The port's slots live in device memory and keep the
    overlapped schedule; the reference's formula with 227 KB of shared
    memory as its budget serializes both, and with its own 16 MiB of VMEM
    the chunk."""
    args = (t_loc, 4096, 8, 128, 2)
    mine = plan.OverlapPlanner().plan_alltoall(*args, torch.bfloat16)
    assert mine.overlap and mine.slots == 2 and mine.cap_pad == t_loc
    assert mine.block_bytes == 64 * t_loc * 4096 * 2
    assert kernel_slots(mine) == 2
    smem = j_plan.OverlapPlanner(vmem_budget=plan.SMEM_BUDGET_DEFAULT)
    assert not smem.plan_alltoall(*args, jnp.bfloat16).overlap
    vmem = j_plan.OverlapPlanner().plan_alltoall(*args, jnp.bfloat16)
    assert vmem.overlap == (t_loc == 2)


def test_measure_expert_load_equals_reference():
    top_e = np.random.RandomState(3).randint(0, 8, (4, 12, 2))
    for a in (top_e, top_e[0]):
        assert measure_expert_load(torch.tensor(a), 8) == \
            j_ref.measure_expert_load(a, 8)
    with pytest.raises(ValueError):
        measure_expert_load(top_e, 8, sources=3)


# -- the expert MLP ---------------------------------------------------------------

def _mlp_case(rng, E, C, d, f):
    x = rng.randn(E, C, d).astype(np.float32)
    ws = [(rng.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
          (rng.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
          (rng.randn(E, f, d) / np.sqrt(f)).astype(np.float32)]
    return x, ws


@pytest.mark.parametrize("shape", [(4, 8, 16, 24), (3, 5, 32, 8),
                                   (2, 17, 24, 40)])
def test_expert_mlp_plain_matches_pallas_and_ref(shape):
    rng = np.random.RandomState(sum(shape))
    x, ws = _mlp_case(rng, *shape)
    got = expert_mlp_plain(torch.tensor(x), *map(torch.tensor, ws)).numpy()
    pallas = np.asarray(j_kernel.expert_mlp_pallas(x, *ws, interpret=True))
    ref = np.asarray(j_ref.expert_mlp_ref(x, *ws))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, pallas, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0)
    # the CPU wrapper is the plain version; the reference form agrees too
    np.testing.assert_array_equal(
        expert_mlp(torch.tensor(x), *map(torch.tensor, ws)).numpy(), got)
    np.testing.assert_allclose(
        expert_mlp_ref(torch.tensor(x), *map(torch.tensor, ws)).numpy(), ref,
        atol=1e-5 * scale, rtol=0)


def test_expert_mlp_zero_rows_and_counts():
    """A zero row maps to a zero row, so rows past a live count may be
    skipped: with counts, those rows come out as exact zeros and the live
    rows are unchanged."""
    rng = np.random.RandomState(1)
    x, ws = _mlp_case(rng, 3, 6, 16, 8)
    counts = np.array([6, 2, 0], np.int32)
    x[1, 2:] = 0.0
    x[2] = 0.0
    tx, tws = torch.tensor(x), [torch.tensor(w) for w in ws]
    full = expert_mlp_plain(tx, *tws)
    assert not full[1, 2:].any() and not full[2].any()
    pallas = np.asarray(j_kernel.expert_mlp_pallas(x, *ws, interpret=True))
    assert not pallas[1, 2:].any() and not pallas[2].any()
    live = expert_mlp_plain(tx, *tws, torch.tensor(counts))
    assert torch.equal(live, full)
    # bf16 operands: h rounds to bf16 before w_down, as the Pallas kernel's
    xb = tx.to(torch.bfloat16)
    wb = [w.to(torch.bfloat16) for w in tws]
    pb = np.asarray(j_kernel.expert_mlp_pallas(
        jnp.asarray(x, jnp.bfloat16), *(jnp.asarray(w, jnp.bfloat16)
                                        for w in ws), interpret=True),
        np.float32)
    got = expert_mlp_plain(xb, *wb).float().numpy()
    assert np.abs(got - pb).max() <= 1.6e-2 * np.abs(pb).max()


def test_expert_mlp_shared_weights_over_sources():
    """Ranks x sources x experts: each rank's weights serve every source
    block of that rank (the a2a regime's landed layout).  A broadcast
    batched matmul sums in another order than one block's, so the blocks
    agree to f32 rounding (1e-6 of the scale), not bit for bit."""
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(2, 3, 4, 5, 8).astype(np.float32))
    ws = [torch.tensor(rng.randn(2, 4, *s).astype(np.float32))
          for s in ((8, 6), (8, 6), (6, 8))]
    got = expert_mlp_plain(x, *ws)
    scale = float(got.abs().max())
    for r in range(2):
        for s in range(3):
            torch.testing.assert_close(
                got[r, s], expert_mlp_plain(x[r, s], *(w[r] for w in ws)),
                rtol=0, atol=1e-6 * scale)


# -- the dispatch -----------------------------------------------------------------

RNG = np.random.RandomState(0)


def _dispatch_case(ndev, E, t_loc, d, f, k=2, skew=2.0):
    """Imbalanced routing, the reference's case: full arrays, the loads
    and the load-sized plans of both packages."""
    toks = RNG.randn(ndev * t_loc, d).astype(np.float32)
    router = (RNG.randn(d, E) + skew * RNG.randn(1, E)).astype(np.float32)
    ws = [(RNG.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
          (RNG.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
          (RNG.randn(E, f, d) / np.sqrt(f)).astype(np.float32)]
    jw, je = jax.jit(j_ref.route_topk, static_argnums=2)(toks, router, k)
    tw, te = route_topk(torch.tensor(toks), torch.tensor(router), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # the weights are f32 softmax probabilities of logits summed in another
    # order (|logit| up to about 30 here): they agree to a few f32 ulps of
    # the logits' scale
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=4e-6)
    loads = measure_expert_load(te.reshape(ndev, t_loc, k), E, sources=ndev)
    tplan = plan.OverlapPlanner().plan_alltoall(t_loc, d, k, E, ndev,
                                                torch.float32, loads=loads)
    jplan = j_plan.OverlapPlanner().plan_alltoall(t_loc, d, k, E, ndev,
                                                  jnp.float32, loads=loads)
    _same_plan(tplan, jplan)
    return dict(toks=toks, router=router, ws=ws, loads=loads, tplan=tplan,
                jplan=jplan, te=te, tw=tw, k=k, ndev=ndev)


def _run_ref(c, impl, jplan, jdc=None):
    mesh = make_mesh((c["ndev"],), ("x",), axis_types="auto")
    k = c["k"]

    def f(tk, rt, g, u, dn):
        w, e = j_ref.route_topk(tk, rt, k)
        with j_default_context().dispatch_stats.collect() as ds:
            out = j_moe_dispatch(tk, e, w, g, u, dn, JGROUP, impl=impl,
                                 plan=jplan)
        return out, ds["moe_dropped"].reshape(1)

    fn = shard_map(f, mesh=mesh,
                   in_specs=(P("x", None), P(None, None), P("x", None, None),
                             P("x", None, None), P("x", None, None)),
                   out_specs=(P("x", None), P("x")))
    with j_use_default(jdc or JContext()):
        out, dropped = jax.jit(fn)(c["toks"], c["router"], *c["ws"])
    return np.asarray(out), float(np.asarray(dropped).sum())


def _run_port(c, impl, tplan, dc=None, **kw):
    mesh = RankMesh(("x",), (c["ndev"],))
    dc = dc or DiompContext(mesh=mesh, device="cpu")
    spec = ("x", None)
    with use_default(dc):
        with dc.dispatch_stats.collect() as ds:
            out = moe_dispatch(
                stack_shards(c["toks"], mesh, spec),
                stack_shards(c["te"].numpy(), mesh, spec),
                stack_shards(c["tw"].numpy(), mesh, spec),
                *(stack_shards(w, mesh, ("x", None, None)) for w in c["ws"]),
                GROUP, impl=impl, plan=tplan, **kw)
    return (unstack_shards(out, mesh, spec), float(ds["moe_dropped"].sum()),
            float(ds["moe_routed"].sum()))


def _oracle(c, mlp=None):
    return moe_ref(torch.tensor(c["toks"]), c["te"], c["tw"],
                   *map(torch.tensor, c["ws"]), mlp=mlp).numpy()


def test_dispatch_buffers_equal_reference():
    c = _dispatch_case(4, E=8, t_loc=8, d=16, f=16)
    toks = c["toks"].reshape(4, 8, 16)
    te, tw = c["te"].reshape(4, 8, 2), c["tw"].reshape(4, 8, 2)
    for p, jp in ((c["tplan"], c["jplan"]),
                  (dataclasses.replace(c["tplan"], caps=(1,) * 8),
                   dataclasses.replace(c["jplan"], caps=(1,) * 8))):
        buf, addr, gates, dropped, counts = dispatch_buffers(
            torch.tensor(toks), te, tw, p)
        for r in range(4):
            jb, ja, jg, jd = j_fused.dispatch_buffers(
                jnp.asarray(toks[r]), jnp.asarray(te[r].numpy()),
                jnp.asarray(tw[r].numpy()), jp)
            np.testing.assert_array_equal(buf[r].numpy(), np.asarray(jb))
            np.testing.assert_array_equal(addr[r].numpy(), np.asarray(ja))
            np.testing.assert_array_equal(gates[r].numpy(), np.asarray(jg))
            assert float(dropped[r]) == float(jd)
            # live rows of each block: the kept choices of each expert,
            # min(routed, cap)
            routed = np.bincount(te[r].reshape(-1).numpy(), minlength=8)
            np.testing.assert_array_equal(counts[r].reshape(-1).numpy(),
                                          np.minimum(routed, p.caps))


@pytest.mark.parametrize("impl", ["fused", "host"])
def test_dispatch_matches_reference_and_oracle(impl):
    c = _dispatch_case(8, E=16, t_loc=12, d=16, f=24)
    assert max(c["loads"]) > min(c["loads"])       # the skew skewed
    want, d_ref = _run_ref(c, impl, c["jplan"])
    got, dropped, routed = _run_port(c, impl, c["tplan"])
    assert d_ref == dropped == 0.0 and routed == 8 * 12 * 2
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    # dropless dispatch only moves data: equal to the oracle bit for bit,
    # with the plain MLP (the kernel's function) and the reference's form
    np.testing.assert_array_equal(got, _oracle(c, expert_mlp_plain))
    emu, _, _ = _run_port(c, impl, c["tplan"], mlp=expert_mlp_ref)
    np.testing.assert_array_equal(emu, _oracle(c))


def test_kernel_wrapper_on_cpu_is_the_plain_emulation():
    c = _dispatch_case(4, E=8, t_loc=8, d=16, f=16)
    mesh = RankMesh(("x",), (4,))
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        args = [stack_shards(a, mesh, ("x", None))
                for a in (c["toks"], c["te"].numpy(), c["tw"].numpy())]
        args += [stack_shards(w, mesh, ("x", None, None)) for w in c["ws"]]
        before = fused_moe_dispatch_kernel.launches
        out, dropped = fused_moe_dispatch_kernel(*args, GROUP,
                                                 plan=c["tplan"])
    assert fused_moe_dispatch_kernel.launches == before
    np.testing.assert_array_equal(unstack_shards(out, mesh, ("x", None)),
                                  _oracle(c, expert_mlp_plain))
    assert not dropped.any()


@pytest.mark.parametrize("lib", ["expert_mlp", "moe_dispatch"])
def test_moe_bindings_match_the_c_entries(lib):
    """The ctypes argument list of each MoE entry point (route code
    included) matches its C signature, parameter by parameter: pointers,
    64-bit strides and ints (no card needed)."""
    import re
    from repro_torch.kernels import _build
    source, fns = _build.LIBRARIES[lib]
    text = (_build.CSRC / source).read_text()
    for fn, argtypes in fns.items():
        params = re.search(r'extern "C" int %s\(([^)]*)\)' % fn,
                           text).group(1)
        kinds = []
        for par in params.split(","):
            par = " ".join(par.split())
            kinds.append(_build._P if "*" in par else
                         _build._LL if par.startswith("long long") else
                         _build._I if par.startswith("int") else None)
        assert kinds == argtypes, fn
        assert params.split(",")[-2].split()[-1] == "route"


def test_undersized_plan_records_reference_drops():
    c = _dispatch_case(4, E=8, t_loc=8, d=16, f=16)
    want, d_ref = _run_ref(c, "fused",
                           dataclasses.replace(c["jplan"], caps=(1,) * 8))
    got, dropped, _ = _run_port(c, "fused",
                                dataclasses.replace(c["tplan"], caps=(1,) * 8))
    assert dropped == d_ref > 0
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(),
                               rtol=0)
    assert np.abs(got - _oracle(c)).max() > 0      # a real quality tax


@pytest.mark.parametrize("impl", ["fused", "host"])
def test_put_logs_and_windows_equal_reference(impl):
    c = _dispatch_case(4, E=8, t_loc=8, d=16, f=16)
    jdc = JContext()
    _run_ref(c, impl, c["jplan"], jdc)
    dc = DiompContext(mesh=RankMesh(("x",), (4,)), device="cpu")
    _run_port(c, impl, c["tplan"], dc)
    desc = GROUP.descriptor()
    assert desc == JGROUP.descriptor()
    assert dc.stats() == jdc.stats()
    assert dc.byte_stats() == jdc.byte_stats()
    assert dc.stats()[desc]["put"] == 2 * 3
    assert dc.byte_stats()[desc]["put"] == 2 * 3 * c["tplan"].block_bytes
    dwin, cwin = dispatch_window_names(GROUP, 4)
    assert dc.rma.window_bytes == jdc.rma.window_bytes
    assert sum(dc.rma.window_bytes[w] for w in dwin + cwin) \
        == dc.rma.put_bytes == jdc.rma.put_bytes
