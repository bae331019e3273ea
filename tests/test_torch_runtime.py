"""The port's unified runtime (``DiompRuntime``, paper Fig. 1(b)) and its
sharding helpers held against the JAX package.

Registration is planning only (no tensor is made), so the tables are
compared exactly: arena offsets, specs (the port keeps one entry per dim;
compared after trimming trailing Nones, the reference's canonical form),
bytes per device, symmetric flags, groups.  ``place`` is compared bit for
bit after ``unstack_shards``.
"""

import numpy as np
import jax
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container without hypothesis: deterministic fallback
    from _minihyp import given, settings, st

from repro import configs as j_configs
from repro.core.runtime import DiompRuntime as JRuntime
from repro.core.runtime import dtype_bytes as j_dtype_bytes
from repro.distributed import sharding as j_shrd
from repro.models import schema as j_schema

import repro_torch as diomp
from repro_torch import configs
from repro_torch.core.context import default_context
from repro_torch.core.groups import DiompGroup
from repro_torch.core.rma import RMAError
from repro_torch.core.runtime import DiompRuntime, dtype_bytes
from repro_torch.distributed import sharding as shrd
from repro_torch.interop import unstack_shards
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import schema

T_MESH8 = make_smoke_mesh(8)


def _trim(spec):
    parts = list(spec)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _runtimes(mesh8, **kw):
    return (JRuntime(mesh8, install_default=False, **kw),
            DiompRuntime(T_MESH8, device="cpu", install_default=False, **kw))


def _rows_equal(jrow, trow):
    assert trow.name == jrow.name
    assert trow.shape == jrow.shape and trow.dtype == jrow.dtype
    assert trow.logical_axes == jrow.logical_axes
    assert _trim(trow.spec) == tuple(jrow.spec), trow.name
    assert len(trow.spec) == len(trow.logical_axes)
    assert trow.symmetric == jrow.symmetric
    assert trow.group.descriptor() == jrow.group.descriptor()
    jr, tr = jrow.region, trow.region
    if not jrow.symmetric:
        jr, tr = jr.region, tr.region
        assert trow.region.slot_offset == jrow.region.slot_offset
    assert tr.offsets == jr.offsets and tr.sizes == jr.sizes, trow.name


def test_glm4_full_tree_table_matches_jax(mesh8):
    """glm4-9b at full width and depth (d_model 4096, d_ff 13696, vocab
    151552, 40 layers) on the 8-rank smoke mesh, pod 2 x data 2 x model 2:
    the registration table equals the reference's row for row."""
    tcfg, jcfg = configs.get("glm4-9b"), j_configs.get("glm4-9b")
    assert (tcfg.d_model, tcfg.d_ff, tcfg.vocab_size, tcfg.num_layers) == \
        (4096, 13696, 151552, 40)
    tsch, jsch = schema.build_schema(tcfg), j_schema.build_schema(jcfg)
    assert sorted(tsch) == sorted(jsch)
    jrt, rt = _runtimes(mesh8)
    names = sorted(tsch)
    jrows = jrt.register_pytree("params", {
        k: (jsch[k].shape, jsch[k].dtype, jsch[k].axes) for k in names})
    rows = rt.register_pytree("params", {
        k: (tsch[k].shape, tsch[k].dtype, tsch[k].axes) for k in names})
    assert list(rows) == list(jrows)
    for k in names:
        _rows_equal(jrows[k], rows[k])
        assert rows[k].region.sizes[0] == shrd.param_bytes_per_device(
            tsch[k].shape, dtype_bytes(tsch[k].dtype), tsch[k].axes, T_MESH8)
    assert [r.name for r in rt.table()] == [r.name for r in jrt.table()]
    assert rt.bytes_in_use() == jrt.bytes_in_use() > 4e9
    for rank in range(8):
        assert rt.bytes_in_use(rank) == jrt.bytes_in_use(rank)
    assert rt.memory.mapping_table() == jrt.memory.mapping_table()
    for k in names:                  # each row opened its RMA window
        with pytest.raises(RMAError, match="already registered"):
            rt.rma.register(f"params/{k}")
    for k in names:
        rt.release(f"params/{k}")
    assert rt.bytes_in_use() == 0
    rt.close()
    jrt.close()


def test_asymmetric_regions_and_translate_match_jax(mesh8):
    jrt, rt = _runtimes(mesh8, segment_bytes=1 << 22)
    sizes = [4096 * (i + 1) for i in range(8)]
    for r in (jrt, rt):
        r.register("w", (256, 128), "bfloat16", ("embed_fsdp", "mlp"))
        r.register("kv", (8, 4096), "bfloat16", (None, None),
                   symmetric=False, sizes=sizes)
        r.register("ragged", (8,), "float32", (None,), symmetric=False,
                   sizes=[0, 64, 0, 128, 256, 0, 32, 8])
    for name in ("w", "kv", "ragged"):
        _rows_equal(jrt.lookup(name), rt.lookup(name))
    assert not rt.lookup("kv").symmetric and rt.lookup("w").symmetric
    for rank in range(8):
        assert rt.memory.translate(rt.lookup("kv").region, rank) == \
            jrt.memory.translate(jrt.lookup("kv").region, rank)
        assert rt.memory.translate(rt.lookup("w").region, rank) == \
            jrt.memory.translate(jrt.lookup("w").region, rank)
    rt.memory.translate(rt.lookup("kv").region, 5)
    jrt.memory.translate(jrt.lookup("kv").region, 5)
    assert rt.memory.ptr_cache.hit_rate == jrt.memory.ptr_cache.hit_rate > 0
    with pytest.raises(Exception):
        rt.lookup("w").region.remote_address(9)
    with pytest.raises(ValueError, match="per-device sizes"):
        rt.register("bad", (8,), "float32", (None,), symmetric=False)
    rt.release("kv")
    jrt.release("kv")
    assert rt.bytes_in_use(3) == jrt.bytes_in_use(3)
    assert {r.name for r in rt.table()} == {"w", "ragged"}


def test_runtime_rejects_duplicates():
    rt = DiompRuntime(T_MESH8, device="cpu", segment_bytes=1 << 20,
                      install_default=False)
    rt.register("x", (16,), "float32", (None,))
    with pytest.raises(ValueError, match="already registered"):
        rt.register("x", (16,), "float32", (None,))
    rt.close()


@given(st.lists(st.integers(1, 1 << 16), min_size=1, max_size=20))
@settings(max_examples=30, deadline=None)
def test_runtime_heap_accounting(sizes):
    """Register/release cycles never leak arena bytes (property)."""
    rt = DiompRuntime(T_MESH8, device="cpu", segment_bytes=1 << 22,
                      install_default=False)
    for i, s in enumerate(sizes):
        rt.register(f"t{i}", (s,), "float32", (None,))
    assert rt.bytes_in_use() >= 4 * sum(sizes)
    for i in range(len(sizes)):
        rt.release(f"t{i}")
    assert rt.bytes_in_use() == 0
    rt.memory.check_invariants()
    rt.close()


def test_default_context_is_shared():
    world = DiompGroup(("pod", "data", "model"), name="world")
    try:
        rt = DiompRuntime(T_MESH8, device="cpu", segment_bytes=1 << 22)
        assert rt.ctx is default_context()
        assert rt.communicator(world).group is world
        assert rt.ccl is rt.ctx.comms and rt.rma is rt.ctx.rma
        assert rt.group("dp").axes == ("pod", "data")
        rt.close()
        other = DiompRuntime(T_MESH8, device="cpu", install_default=False)
        assert other.ctx is not default_context()
        shared = DiompRuntime(T_MESH8, context=rt.ctx, install_default=False)
        assert shared.memory is rt.memory and shared.device == rt.device
    finally:
        diomp.reset_default_context()


@pytest.mark.parametrize("name,shape,dtype,axes", [
    ("embed", (48, 16), "float32", ("vocab", None)),
    ("w", (16, 24), "bfloat16", ("embed_fsdp", "mlp")),
    ("batch", (8, 6, 4), "float32", ("batch", None, "heads")),
    ("rep", (5, 3), "float32", (None, None)),
])
def test_place_matches_jax(mesh8, name, shape, dtype, axes):
    rng = np.random.RandomState(0)
    value = rng.randn(*shape).astype(np.float32)
    jrt, rt = _runtimes(mesh8, segment_bytes=1 << 22)
    jrt.register(name, shape, dtype, axes)
    rt.register(name, shape, dtype, axes)
    want = np.asarray(jrt.place(name, value))
    got = rt.place(name, value)
    sh = rt.sharding_for(name)
    assert isinstance(sh, shrd.RankSharding) and sh.mesh == T_MESH8
    assert _trim(sh.spec) == tuple(jrt.sharding_for(name).spec)
    assert got.device.type == "cpu" and got.shape[:3] == (2, 2, 2)
    np.testing.assert_array_equal(unstack_shards(got, T_MESH8, sh.spec),
                                  want)
    # every replica holds the same bytes
    for a in T_MESH8.axis_names:
        if a not in str(sh.spec):
            d = T_MESH8.dim(a)
            assert torch.equal(got.select(d, 0), got.select(d, 1))


@pytest.mark.parametrize("shape,axes", [
    ((151552, 4096), ("vocab", None)),
    ((40, 4096, 13696), (None, "embed_fsdp", "mlp")),
    ((7, 5, 3), ("batch", "heads", "embed_fsdp")),
    ((9, 3), ("heads",)),                     # fewer axes than dims
    ((13,), ("mlp",)),                        # a padded (ceil-div) shard
    ((6, 6), ("expert", "kv_heads")),
])
@pytest.mark.parametrize("nbytes", [1, 2, 4])
def test_param_bytes_per_device_matches_jax(mesh8, shape, axes, nbytes):
    assert shrd.param_bytes_per_device(shape, nbytes, axes, T_MESH8) == \
        j_shrd.param_bytes_per_device(shape, nbytes, axes, mesh8)
    spec = shrd.named_sharding(axes, T_MESH8).spec
    assert len(spec) == len(axes)
    assert _trim(spec) == tuple(j_shrd.named_sharding(axes, mesh8).spec)
    assert shrd.RankSharding(T_MESH8, spec) == \
        shrd.named_sharding(axes, T_MESH8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8",
                                   "uint8", "int32", "int64", "bool",
                                   "float64", "uint32"])
def test_dtype_bytes_match_jax(dtype):
    assert dtype_bytes(dtype) == j_dtype_bytes(dtype)
    if hasattr(torch, dtype):
        assert dtype_bytes(getattr(torch, dtype)) == j_dtype_bytes(dtype)


def test_report_and_fence():
    rt = DiompRuntime(T_MESH8, device="cpu", segment_bytes=1 << 22,
                      install_default=False)
    rt.register("w", (256, 128), "bfloat16", ("embed_fsdp", "mlp"))
    text = rt.report()
    assert "8 ranks on cpu" in text and "w " in text and "sym" in text
    rt.fence()
    rt.close()


def test_runtime_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DiompRuntime(T_MESH8, install_default=False)
