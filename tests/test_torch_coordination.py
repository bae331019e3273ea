"""Single-process unit tests of the port's multi-process bootstrap layer,
the counterparts of ``tests/test_coordination.py``.

The cross-process behaviour runs for real in
``tests/test_torch_multiproc.py``; here are the pieces that must hold in
ANY topology: LocalCoordinator semantics (the identity exchange every
single-process run uses), a one-process gloo job, process-local arena
guards in GlobalMemory, the local_sizes/sizes contract of the extent
exchange (held against the reference's GlobalMemory), mesh validation and
the process boxes of a split mesh, the ``diomp.init`` argument contract
and the single-process shape of ``gather_stats``.
"""

import socket

import numpy as np
import pytest
import torch

from repro.core.groups import DiompGroup as JGroup
from repro.core.pgas import GlobalMemory as JGlobalMemory

from repro_torch.core import coordination
from repro_torch.core.context import DiompContext, init, reset_default_context
from repro_torch.core.coordination import (CoordinationError,
                                           LocalCoordinator,
                                           TorchCoordinator, assemble,
                                           coordinator_for,
                                           device_process_map, fetch_global,
                                           init_distributed, is_distributed,
                                           process_local_ranks, rank_gather)
from repro_torch.core.groups import DiompGroup, GroupError
from repro_torch.core.pgas import AllocError, GlobalMemory
from repro_torch.launch.mesh import (RankMesh, make_process_mesh,
                                     make_smoke_mesh)

G = DiompGroup(("x",), name="x")
MESH8 = RankMesh(("pod", "data", "model"), (2, 2, 2))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def one_process_job():
    """A one-process gloo job of 8 ranks, left in teardown (xdist workers
    share nothing else, so nothing may outlive the test)."""
    if not torch.distributed.is_gloo_available():
        pytest.skip("torch.distributed has no gloo transport here")
    coordinator = f"127.0.0.1:{_free_port()}"
    init_distributed(coordinator, 1, 0, local_device_count=8)
    try:
        yield coordinator
    finally:
        coordination.shutdown()


# ---------------------------------------------------------------------------
# coordinators
# ---------------------------------------------------------------------------


def test_local_coordinator_identity():
    c = LocalCoordinator()
    assert c.process_id == 0 and c.num_processes == 1
    assert c.allgather({"a": (1, 2)}) == [{"a": [1, 2]}]  # JSON round-trip
    assert c.broadcast("x") == "x"
    assert c.agree(["anything"])
    c.barrier("tag")  # no-op, no traffic


def test_coordinator_for_single_process():
    assert isinstance(coordinator_for(MESH8), LocalCoordinator)
    assert not is_distributed()


def test_torch_coordinator_single_process_roundtrip(one_process_job):
    # a 1-process job degenerates to the identity exchange
    c = TorchCoordinator()
    assert c.process_id == 0 and c.num_processes == 1
    assert c.allgather_bytes(b"payload") == [b"payload"]
    assert c.allgather([1, "two"]) == [[1, "two"]]
    assert is_distributed() and isinstance(coordinator_for(), TorchCoordinator)
    # idempotent with the same topology, refused with another one
    assert init_distributed(one_process_job, 1, 0,
                            local_device_count=8) == (0, 1)
    with pytest.raises(CoordinationError, match="different topology"):
        init_distributed(one_process_job, 1, 0, local_device_count=4)
    mesh = make_process_mesh()
    assert mesh.size == 8 and not mesh.multiprocess


def test_torch_coordinator_needs_a_job():
    with pytest.raises(CoordinationError, match="init_distributed"):
        TorchCoordinator()


def test_fetch_global_is_plain_numpy_locally():
    x = np.arange(12.0).reshape(3, 4)
    got = fetch_global(x)
    np.testing.assert_array_equal(got, x)
    t = torch.arange(8.0).reshape(2, 4)
    assert fetch_global(t, RankMesh(("x",), (2,))) is t


def test_process_local_ranks_covers_mesh():
    assert process_local_ranks(MESH8) == list(range(MESH8.size))
    assert device_process_map(MESH8) == [0] * MESH8.size


# ---------------------------------------------------------------------------
# GlobalMemory: process-local arenas + extent exchange contract
# ---------------------------------------------------------------------------


def test_remote_rank_arena_is_guarded():
    gm = GlobalMemory(4, 1 << 12, local_ranks=[0, 1])
    slp = gm.alloc_asymmetric("kv", [64, 64, 0, 0], G)
    assert slp.region.offsets[2] == -1
    assert gm.bytes_in_use(0) > 0
    with pytest.raises(AllocError, match="not process-local"):
        gm.bytes_in_use(3)
    with pytest.raises(AllocError, match="outside"):
        gm.bytes_in_use(7)


def test_alloc_asymmetric_exactly_one_of_sizes_and_local_sizes():
    gm = GlobalMemory(2, 1 << 12)
    with pytest.raises(ValueError, match="exactly one"):
        gm.alloc_asymmetric("both", [8, 8], G, local_sizes=[8, 8])
    with pytest.raises(ValueError, match="exactly one"):
        gm.alloc_asymmetric("neither", group=G)


def test_alloc_asymmetric_local_sizes_must_cover_local_ranks():
    gm = GlobalMemory(4, 1 << 12, local_ranks=[1, 2])
    with pytest.raises(ValueError, match="local sizes"):
        gm.alloc_asymmetric("short", group=G, local_sizes=[64])
    # partial visibility without peer processes: the assembled size
    # vector cannot cover every rank, and the exchange says so
    with pytest.raises(AllocError, match="covered ranks"):
        gm.alloc_asymmetric("uncovered", group=G, local_sizes=[64, 128])


def test_local_sizes_equals_global_sizes_table():
    """One process owning every rank: the contribution path builds the
    identical region the global-vector path builds — and the reference's
    GlobalMemory builds the same table."""
    gm_a = GlobalMemory(4, 1 << 12)
    gm_b = GlobalMemory(4, 1 << 12)
    a = gm_a.alloc_asymmetric("kv", [32, 64, 0, 128], G)
    b = gm_b.alloc_asymmetric("kv", group=G, local_sizes=[32, 64, 0, 128])
    assert a.region.sizes == b.region.sizes
    assert a.region.offsets == b.region.offsets
    ref = JGlobalMemory(4, 1 << 12).alloc_asymmetric(
        "kv", group=JGroup(("x",), name="x"), local_sizes=[32, 64, 0, 128])
    assert (b.region.sizes, b.region.offsets) == (ref.region.sizes,
                                                  ref.region.offsets)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_make_smoke_mesh_validates_ndev():
    for bad in (0, -1):
        with pytest.raises(ValueError, match="positive"):
            make_smoke_mesh(bad)
    # ranks are virtual: any count makes a mesh, but a process mesh covers
    # exactly the job's ranks
    assert make_smoke_mesh(4096).size == 4096
    with pytest.raises(ValueError, match="covers"):
        make_process_mesh(shape=(4096,), axes=("x",))


def test_make_process_mesh_single_process_defaults():
    mesh = make_process_mesh()
    assert mesh.size == coordination.local_device_count()
    assert not mesh.multiprocess and mesh.local_sizes == mesh.sizes


def test_make_process_mesh_explicit_ring():
    n = coordination.local_device_count()
    mesh = make_process_mesh(shape=(n,), axes=("x",))
    assert dict(mesh.shape) == {"x": n}
    with pytest.raises(ValueError, match="explicit axes"):
        make_process_mesh(shape=(n,))
    with pytest.raises(ValueError, match="covers"):
        make_process_mesh(shape=(n + 1,), axes=("x",))
    with pytest.raises(ValueError, match="rank mismatch"):
        make_process_mesh(shape=(n, 1), axes=("x",))


def test_make_process_mesh_validates_claimed_topology():
    with pytest.raises(ValueError, match="local devices"):
        make_process_mesh(
            ndev_per_proc=coordination.local_device_count() + 1)
    with pytest.raises(ValueError, match="processes"):
        make_process_mesh(num_processes=2)


@pytest.mark.parametrize("sizes,k,boxes", [
    # 2 x 2 on a ring of 4: x[2p:2p+2]
    ((4,), 2, [((0, 2),), ((2, 4),)]),
    # 4 x 1 on (2, 2): [i, j:j+1]
    ((2, 2), 1, [((0, 1), (0, 1)), ((0, 1), (1, 2)), ((1, 2), (0, 1)),
                 ((1, 2), (1, 2))]),
    # 2 x 2 on (2, 2): a row each
    ((2, 2), 2, [((0, 1), (0, 2)), ((1, 2), (0, 2))]),
    # the smoke mesh over 4 processes: a (pod, data) pair each
    ((2, 2, 2), 2, [((0, 1), (0, 1), (0, 2)), ((0, 1), (1, 2), (0, 2)),
                    ((1, 2), (0, 1), (0, 2)), ((1, 2), (1, 2), (0, 2))]),
])
def test_process_boxes_are_process_major_blocks(sizes, k, boxes):
    axes = ("a", "b", "c")[:len(sizes)]
    for p, want in enumerate(boxes):
        mesh = RankMesh(axes, sizes, ranks_per_process=k, process_id=p)
        assert tuple((b.start, b.stop) for b in mesh.box) == want
        assert list(mesh.local_ranks) == list(range(p * k, (p + 1) * k))
        assert mesh.local_size == k and mesh.num_processes == len(boxes)
        assert device_process_map(mesh) == [r // k for r in range(mesh.size)]


def test_process_blocks_must_be_boxes():
    with pytest.raises(ValueError, match="not boxes"):
        RankMesh(("a", "b"), (2, 3), ranks_per_process=2)
    with pytest.raises(ValueError, match="blocks of"):
        RankMesh(("a",), (4,), ranks_per_process=3)
    with pytest.raises(ValueError, match="outside"):
        RankMesh(("a",), (4,), ranks_per_process=2, process_id=2)


def test_data_plane_is_local_in_one_process():
    """One process holds every rank: a gather by source rank is a copy
    within the box, an assembly the box itself — no traffic."""
    mesh = RankMesh(("x",), (4,))
    x = torch.arange(12.0).reshape(4, 3)
    before = dict(coordination.TRANSPORT)
    got = rank_gather(x, mesh, [3, None, 0, 1])
    torch.testing.assert_close(got, torch.stack(
        [x[3], torch.zeros(3), x[0], x[1]]))
    assert torch.equal(assemble(x, mesh, lambda p: range(4)), x)
    assert coordination.TRANSPORT == before


# ---------------------------------------------------------------------------
# diomp.init + gather_stats
# ---------------------------------------------------------------------------


def test_init_topology_args_require_coordinator():
    with pytest.raises(ValueError, match="coordinator"):
        init(num_processes=2)
    with pytest.raises(ValueError, match="coordinator"):
        init(process_id=0)
    reset_default_context()


def test_init_accepts_coordinator_instance():
    ctx = init(mesh=MESH8, coordinator=LocalCoordinator(), device="cpu")
    try:
        assert ctx.process_id == 0 and ctx.num_processes == 1
        assert not ctx.multiprocess
    finally:
        reset_default_context()


def test_context_refuses_a_mesh_of_another_process_split():
    """A two-process coordinator over a mesh this process holds whole (or
    splits otherwise) would duplicate ranks: refused before any exchange."""
    class TwoProcesses(LocalCoordinator):
        num_processes = 2

    with pytest.raises(GroupError, match="make_process_mesh"):
        DiompContext(mesh=MESH8, device="cpu", coordinator=TwoProcesses())
    split = RankMesh(("x",), (4,), ranks_per_process=2, process_id=1)
    with pytest.raises(GroupError, match="owns no rank"):
        DiompContext(mesh=split, device="cpu")


def test_gather_stats_single_process_shape():
    ctx = DiompContext(mesh=MESH8, device="cpu", segment_bytes=1 << 16)
    ctx.memory.alloc_symmetric("a", 512, G)
    rows = ctx.gather_stats()
    assert len(rows) == 1
    (row,) = rows
    assert row["process_id"] == 0
    assert row["pgas"]["alloc_counts"]["symmetric"] == 1
    names = [r[0] for r in row["pgas"]["regions"]]
    assert "a" in names
    for key in ("stats", "byte_stats", "retry_stats", "rma"):
        assert key in row


def test_cross_process_routes_are_explicit():
    """Where a ring crosses processes the card's routes change by rule,
    not by fallback: the fused ring runs step by step (row 1 a GEMM), the
    fused step's carried schedule runs over the box (``carried_part``) and
    its single step, whose puts land inside its launch, on the emulation;
    the CPU keeps the emulation either way."""
    from repro_torch.kernels.plan import HaloPlan
    from repro_torch.kernels.ring_matmul.fused import fused_ring_route
    from repro_torch.kernels.stencil.fused import fused_step_route

    ring = dict(custom_dot=False, mesh_ndim=1)
    assert fused_ring_route(on_card=True, crosses=False, **ring) == "kernel"
    assert fused_ring_route(on_card=True, crosses=True, **ring) == "stepwise"
    assert fused_ring_route(on_card=False, crosses=True, **ring) \
        == "emulation"
    assert fused_ring_route(on_card=True, crosses=True, custom_dot=True,
                            mesh_ndim=1) == "emulation"
    plan = HaloPlan(nz=4, ny=1, z_loc=16, y_loc=8, x=16)
    step = dict(dtype=torch.float32, dim=5, ny=1, z_extents=None, plan=plan,
                halos=None)
    for crosses, carried, single in ((False, "carried", "single"),
                                     (True, "carried_part", "emulation")):
        assert fused_step_route(on_card=True, return_halos=True,
                                crosses=crosses, **step) == carried
        assert fused_step_route(on_card=True, return_halos=False,
                                crosses=crosses, **step) == single
        assert fused_step_route(on_card=False, return_halos=True,
                                crosses=crosses, **step) == "emulation"
