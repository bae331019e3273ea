"""The port across real operating-system processes (torch.distributed over
gloo), held against the single-process port and the reference.

This file is also the SPMD worker: ``python tests/test_torch_multiproc.py
--coordinator host:port --num-processes N --process-id I ...`` joins the
job through ``diomp.init(coordinator=...)``, runs the requested cases over
the job's global ranks and writes a JSON result file (it imports torch and
the port only).  The session fixtures launch it at 1x4, 2x2 and 4x1
(processes x ranks each; the same 4 global ranks) and at 2x2 under
``DIOMP_CHAOS_SEED=1234``, ``p = 0.15``, drop and fail — the reference
harness's topologies and chaos arming (``tests/multiproc/mp_launcher.py``),
whose cases this mirrors at its sizes: ``pgas``, ``ring_matmul``
(A 4n x 24, B 24 x 8n), ``minimod`` (grid 8n x 8 x 16, 2 steps; fused,
host, and the weighted asymmetric run; here also the two-sided baseline
and a fused run at 16 Z rows a rank, where the planner overlaps),
``determinism`` and ``chaos_ring``.

The assertions are the reference harness's
(``tests/multiproc/test_multiproc_{equivalence,determinism,chaos}.py``),
plus: every topology's outputs and logs equal the single-process port's
(the same cases run in this process, no job joined) bit for bit, and the
single-process outputs agree with the reference run in-process on the CPU
within the tolerances of ``tests/test_torch_ring_matmul.py`` (f32
products to 1e-4 of their scale) and ``tests/test_torch_minimod.py``
(fields to 3e-6 absolute; every counter equal).  The reference's own
multi-process tests fail on this box's jax, so the port's processes are
held against these instead.

Each case also runs once with the card's routes forced on the CPU (the
kernel wrappers' CPU paths are the plain versions): the fused ring takes
its one-launch route at 1x4 and its step-by-step route where the ring
crosses processes, fused Minimod its carried schedule over the whole ring
or over each process's box, and those outputs are bit for bit the
unforced ones at every topology.
"""

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
N_RANKS = 4
CHAOS_SEED = 1234
TIMEOUT_S = 180
COMPUTE_CASES = ("pgas", "ring_matmul", "minimod", "determinism")
LAUNCHES = {             # tag -> (processes, ranks each, chaos seed, cases)
    "1x4": (1, 4, None, COMPUTE_CASES),
    "2x2": (2, 2, None, COMPUTE_CASES),
    "4x1": (4, 1, None, COMPUTE_CASES),
    "2x2-chaos": (2, 2, CHAOS_SEED, ("chaos_ring",)),
}
CHAOS_ENV = ("DIOMP_CHAOS_SEED", "DIOMP_CHAOS_P", "DIOMP_CHAOS_KINDS",
             "DIOMP_CHAOS_VERBS")


# ---------------------------------------------------------------------------
# the worker's cases (also run in this process, as the single-process port)
# ---------------------------------------------------------------------------


def _digest(arr):
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _obj_digest(obj):
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True).encode("utf-8")).hexdigest()


def _log_report(ctx):
    """Collective log snapshot -> parity flag + cross-run digests."""
    rows = ctx.gather_stats()
    canon = json.loads(json.dumps(
        [{k: v for k, v in r.items() if k != "process_id"} for r in rows]))
    parity = all(r == canon[0] for r in canon)
    mine = canon[0]
    logical = {k: mine[k] for k in ("stats", "byte_stats", "rma", "pgas")}
    rma = {k: v for k, v in logical["rma"].items()
           if k not in ("retry_puts", "retry_bytes")}
    logical = dict(logical, rma=rma)
    ompccl_put_bytes = sum(
        int(d.get("put", 0)) for d in mine["byte_stats"].values())
    return {
        "rank_parity": parity,
        "logs_digest": _obj_digest(canon),
        "logical_digest": _obj_digest(logical),
        "retry_total": sum(sum(d.values()) for d in
                           mine["retry_stats"].values()),
        "ompccl_put_bytes": ompccl_put_bytes,
        "tracker_put_bytes": int(mine["rma"]["put_bytes"]),
        "byte_parity": ompccl_put_bytes == int(mine["rma"]["put_bytes"]),
    }


def _ring_mesh():
    from repro_torch.core import coordination
    from repro_torch.launch.mesh import RankMesh, make_process_mesh

    if coordination.is_distributed():
        return make_process_mesh(shape=(N_RANKS,), axes=("x",))
    return RankMesh(("x",), (N_RANKS,))


@contextmanager
def _card_routes():
    """Route the fused ring and the fused step as on the card (their
    wrappers' CPU paths are the plain versions); yields the route counters
    the block adds to."""
    from repro_torch.kernels.ring_matmul import fused as r_fused
    from repro_torch.kernels.stencil import fused as s_fused

    saved = (r_fused.fused_ring_route, s_fused.fused_step_route)
    before = (dict(r_fused.fused_ring_allgather_matmul.routes),
              dict(s_fused.fused_wave_step.routes))
    r_fused.fused_ring_route = \
        lambda **kw: saved[0](**{**kw, "on_card": True})
    s_fused.fused_step_route = \
        lambda **kw: saved[1](**{**kw, "on_card": True})
    taken = {}
    try:
        yield taken
    finally:
        r_fused.fused_ring_route, s_fused.fused_step_route = saved
        for name, b, now in (
                ("ring", before[0], r_fused.fused_ring_allgather_matmul.routes),
                ("step", before[1], s_fused.fused_wave_step.routes)):
            taken[name] = {k: now[k] - b[k] for k in now if now[k] != b[k]}


def _ring_inputs(mesh):
    from repro_torch.interop import stack_shards

    rng = np.random.RandomState(0)
    A = rng.randn(4 * N_RANKS, 24).astype(np.float32)
    B = rng.randn(24, 8 * N_RANKS).astype(np.float32)
    return (A, B), (stack_shards(A, mesh, ("x", None)),
                    stack_shards(B, mesh, (None, "x")))


def ring_matmul_outputs(report_chaos=False):
    """The ring case's global outputs (numpy, every process), report and
    context."""
    from repro_torch.core.context import DiompContext, use_default
    from repro_torch.core.groups import DiompGroup
    from repro_torch.interop import unstack_shards
    from repro_torch.kernels.ring_matmul.ops import ring_allgather_matmul
    from repro_torch.kernels.ring_matmul.ref import ring_allgather_matmul_ref

    mesh = _ring_mesh()
    group = DiompGroup(("x",), name="ring")
    ctx = DiompContext(mesh=mesh, device="cpu", segment_bytes=1 << 20)
    _, (x, w) = _ring_inputs(mesh)
    spec = (None, "x")
    out = {}
    with use_default(ctx):
        for impl in ("fused", "host"):
            out[impl] = unstack_shards(
                ring_allgather_matmul(x, w, group, impl=impl), mesh, spec)
        out["ref"] = unstack_shards(ring_allgather_matmul_ref(x, w, group),
                                    mesh, spec)
    rep = {"digests": {k: _digest(v) for k, v in out.items()},
           "fused_eq_ref": bool(np.array_equal(out["fused"], out["ref"])),
           **_log_report(ctx)}
    if report_chaos:
        fp = ctx.fault_plan
        rep["chaos"] = {
            "armed": fp is not None,
            "injected": dict(fp.injected_counts()) if fp else {},
            "injected_total": len(fp.injected) if fp else 0,
            "unrecovered": len(fp.unrecovered()) if fp else -1,
        }
    else:
        # the card's routes, forced on the CPU, in a context of their own
        routed = DiompContext(mesh=mesh, device="cpu", segment_bytes=1 << 20)
        with use_default(routed), _card_routes() as taken:
            y = ring_allgather_matmul(x, w, group, impl="fused")
        rep["routed"] = {"digest": _digest(unstack_shards(y, mesh, spec)),
                         "routes": taken,
                         "logical_digest": _log_report(routed)[
                             "logical_digest"]}
    return out, rep, ctx


def case_ring_matmul():
    return ring_matmul_outputs()[1]


def case_chaos_ring():
    """The ring program with DIOMP_CHAOS_* armed by the launcher."""
    return ring_matmul_outputs(report_chaos=True)[1]


MINIMOD_RUNS = {
    "fused": dict(grid=(8 * N_RANKS, 8, 16), mode="fused"),
    "host": dict(grid=(8 * N_RANKS, 8, 16), mode="host"),
    # asymmetric decomposition: rank 0 owns a double-weight slab
    "weighted": dict(grid=(10 * N_RANKS, 8, 16), mode="fused",
                     weights=tuple(2.0 if r == 0 else 1.0
                                   for r in range(N_RANKS))),
    # the two-sided baseline (paper Listing 2): gathers and a barrier
    "none": dict(grid=(8 * N_RANKS, 8, 16), mode="none"),
    # 16 Z rows a rank: the planner overlaps (at 8 the interior is empty
    # and it falls back), so the time loop carries its halos
    "overlap": dict(grid=(16 * N_RANKS, 8, 16), mode="fused"),
}


def minimod_runs():
    """Every Minimod run of the case (and the fused run on the card's
    routes), as MinimodResults."""
    from repro_torch.apps.minimod import run_minimod

    runs = {tag: run_minimod(steps=2, nz=N_RANKS, ny=1, device="cpu", **kw)
            for tag, kw in MINIMOD_RUNS.items()}
    with _card_routes() as taken:
        runs["overlap_routed"] = run_minimod(steps=2, nz=N_RANKS, ny=1,
                                             device="cpu",
                                             **MINIMOD_RUNS["overlap"])
    return runs, taken


def case_minimod():
    runs, taken = minimod_runs()
    out = {}
    for tag, r in runs.items():
        out[tag] = {
            "digest": _digest(r.field.numpy()),
            "energy": float(r.energy),
            "z_extents": list(r.z_extents),
            "puts": int(r.puts),
            "put_bytes": int(r.put_bytes),
            "byte_parity": (r.puts == r.tracker_puts
                            and r.put_bytes == r.tracker_put_bytes),
            "region_sizes": list(r.region_sizes),
            "alloc_counts": dict(r.alloc_counts),
            "fences": int(r.fences),
            "window_bytes": dict(r.window_bytes),
        }
    out["overlap_routed"]["routes"] = taken
    out["overlap"]["overlapped"] = bool(runs["overlap"].plan.overlap)
    return out


def case_pgas():
    from repro_torch.core.context import DiompContext
    from repro_torch.core.groups import DiompGroup
    from repro_torch.core.pgas import AllocError

    n = N_RANKS
    group = DiompGroup(("x",), name="x")
    ctx = DiompContext(mesh=_ring_mesh(), device="cpu", segment_bytes=1 << 16)
    mem = ctx.memory
    r1 = mem.alloc_symmetric("sym-a", 2048, group)
    # global-vector asymmetric: every process passes the same sizes
    slp = mem.alloc_asymmetric("rag", [256 * (r + 1) for r in range(n)],
                               group)
    # per-process contribution: each process speaks only for its ranks
    slp2 = mem.alloc_asymmetric(
        "rag-local", group=group,
        local_sizes=[384 * (r + 1) for r in mem.local_ranks])
    # churn, then a symmetric alloc that must coordinate: the ragged allocs
    # diverged the arenas, so the common offset comes from the free-extent
    # intersection protocol, not the local fast path
    mem.free(r1)
    r2 = mem.alloc_symmetric("sym-b", 1024, group)
    mem.check_invariants()
    oversize_raises = False
    try:
        mem.alloc_symmetric("too-big", 1 << 20, group)
    except AllocError:
        oversize_raises = True
    table = [
        [row["name"], bool(row["symmetric"]), list(row["bytes"]),
         list(row["offsets"])]
        for row in sorted(mem.mapping_table(), key=lambda r: r["rid"])
    ]
    return {
        "table": table,
        "table_digest": _obj_digest(table),
        "sym_b_offsets_identical": len(set(r2.offsets)) == 1,
        "rag_offsets": list(slp.region.offsets),
        "rag_local_sizes": list(slp2.region.sizes),
        "oversize_raises": oversize_raises,
        "alloc_counts": dict(mem.alloc_counts),
        **_log_report(ctx),
    }


def case_determinism():
    """Seeded substrates must be process-invariant: the fault schedule,
    the sha256-derived RNG streams, and the serving arrival trace."""
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.resilience import derive_rng
    from repro_torch.serve.trace import bursty_trace

    plan = FaultPlan(seed=1234, p=0.3, kinds=("drop", "fail", "timeout"))
    stream = []
    for i in range(240):
        f = plan.next_fault(("put", "get", "allreduce")[i % 3])
        stream.append(None if f is None else [f.verb, f.call_index, f.kind])
    rngs = [[round(derive_rng("halo", i, tag).random(), 17)
             for tag in ("x", "y")] for i in range(32)]
    trace = [repr(r) for r in bursty_trace(seed=7, n=48)]
    return {
        "fault_digest": _obj_digest(stream),
        "rng_digest": _obj_digest(rngs),
        "trace_digest": _obj_digest(trace),
        "injected_counts": plan.injected_counts(),
    }


CASES = {
    "pgas": case_pgas,
    "ring_matmul": case_ring_matmul,
    "minimod": case_minimod,
    "determinism": case_determinism,
    "chaos_ring": case_chaos_ring,
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--ndev-per-proc", type=int, required=True)
    ap.add_argument("--cases", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import repro_torch as diomp
    from repro_torch.core import coordination

    torch.set_num_threads(1)
    diomp.init(coordinator=args.coordinator,
               num_processes=args.num_processes, process_id=args.process_id,
               local_device_count=args.ndev_per_proc, device="cpu")
    result = {"process_id": args.process_id,
              "num_processes": args.num_processes,
              "ndev_per_proc": coordination.local_device_count(),
              "global_devices": _ring_mesh().size, "cases": {}}
    for name in args.cases.split(","):
        result["cases"][name] = CASES[name]()
    # what the data plane moved, apart from the result blob
    transport = dict(coordination.TRANSPORT)
    tmp = args.out + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"result": result, "transport": transport}, fh, indent=1,
                  sort_keys=True)
    os.replace(tmp, args.out)
    # every process finishes before any leaves the job
    coordination.TorchCoordinator().barrier("done")
    coordination.shutdown()
    return 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Launch:
    """One topology's worker processes, started at once."""

    def __init__(self, tag, directory):
        procs, local, chaos, cases = LAUNCHES[tag]
        self.tag, self.dir = tag, directory
        env = {k: v for k, v in os.environ.items() if k not in CHAOS_ENV}
        env["PYTHONPATH"] = str(ROOT / "src")
        env["OMP_NUM_THREADS"] = "1"
        if chaos is not None:
            env.update(DIOMP_CHAOS_SEED=str(chaos), DIOMP_CHAOS_P="0.15",
                       DIOMP_CHAOS_KINDS="drop,fail")
        port = _free_port()
        self.procs, self.logs = [], []
        for pid in range(procs):
            log = self.dir / f"proc{pid}.log"
            self.logs.append(log)
            with open(log, "w") as fh:
                self.procs.append(subprocess.Popen(
                    [sys.executable, __file__,
                     "--coordinator", f"127.0.0.1:{port}",
                     "--num-processes", str(procs),
                     "--process-id", str(pid),
                     "--ndev-per-proc", str(local),
                     "--cases", ",".join(cases),
                     "--out", str(self.dir / f"result{pid}.json")],
                    env=env, cwd=str(ROOT), stdout=fh,
                    stderr=subprocess.STDOUT))
        self.deadline = time.monotonic() + TIMEOUT_S
        self._results = None

    def _tails(self):
        return "\n".join(
            f"--- {self.tag} proc{i} (exit {p.returncode}) ---\n"
            + "\n".join(log.read_text(errors="replace").splitlines()[-30:])
            for i, (p, log) in enumerate(zip(self.procs, self.logs)))

    def results(self):
        if self._results is None:
            # until every worker exits, one fails (its peers would wait on
            # it in gloo) or the launch's time is up
            while time.monotonic() < self.deadline \
                    and any(p.poll() is None for p in self.procs) \
                    and not any(p.poll() for p in self.procs):
                time.sleep(0.1)
            done = all(p.poll() == 0 for p in self.procs)
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            if done:
                self._results = [
                    json.loads((self.dir / f"result{i}.json").read_text())
                    for i in range(len(self.procs))]
            else:
                self._results = AssertionError(
                    f"{self.tag} failed or ran past {TIMEOUT_S} s\n"
                    + self._tails())
        if isinstance(self._results, AssertionError):
            raise self._results
        return self._results


@pytest.fixture(scope="session")
def launches(tmp_path_factory):
    """Every launch, started together (they run side by side); each
    fixture below waits for its own.  Whatever is still running at the
    session's end is killed."""
    import torch.distributed as dist

    if not dist.is_gloo_available():
        pytest.skip("torch.distributed has no gloo transport here")
    started = {tag: _Launch(tag, tmp_path_factory.mktemp(f"mp-{tag}"))
               for tag in LAUNCHES}
    yield started
    for launch in started.values():
        for p in launch.procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _res(runs):
    return [r["result"] for r in runs]


@pytest.fixture(scope="session")
def baseline(launches):
    """One process holding the 4 ranks."""
    return _res(launches["1x4"].results())


@pytest.fixture(scope="session")
def two_proc(launches):
    """2 real processes x 2 ranks each (the same 4 global ranks)."""
    return _res(launches["2x2"].results())


@pytest.fixture(scope="session")
def four_proc(launches):
    """4 real processes x 1 rank each."""
    return _res(launches["4x1"].results())


@pytest.fixture(scope="session")
def chaos_two(launches):
    """2x2 with DIOMP_CHAOS_* armed in the workers' environment."""
    return _res(launches["2x2-chaos"].results())


@pytest.fixture(scope="session")
def transport(launches):
    return {tag: [r["transport"] for r in launches[tag].results()]
            for tag in LAUNCHES}


@pytest.fixture(scope="session")
def single():
    """The same cases in this process, no job joined: the single-process
    port the processes are held against."""
    saved = {k: os.environ.pop(k) for k in CHAOS_ENV if k in os.environ}
    try:
        return {name: CASES[name]() for name in COMPUTE_CASES}
    finally:
        os.environ.update(saved)


def _cases(results, pid=0):
    return results[pid]["cases"]


def _strip_pid(result):
    return json.dumps({k: v for k, v in result.items()
                       if k != "process_id"}, sort_keys=True)


# ---------------------------------------------------------------------------
# the job really is multi-process
# ---------------------------------------------------------------------------


def test_topology(baseline, two_proc, four_proc):
    for results, procs, local in ((baseline, 1, 4), (two_proc, 2, 2),
                                  (four_proc, 4, 1)):
        assert len(results) == procs
        for pid, r in enumerate(results):
            assert r["process_id"] == pid
            assert r["num_processes"] == procs
            assert r["ndev_per_proc"] == local   # per-process ranks
            assert r["global_devices"] == N_RANKS


def test_every_process_reports_identical_results(two_proc, four_proc):
    """SPMD: modulo its process id, every process's full result blob —
    digests, logs, mapping tables — is byte-identical."""
    for results in (two_proc, four_proc):
        assert len({_strip_pid(r) for r in results}) == 1


def test_transport_moved_bytes_only_across_processes(transport):
    """One process moves nothing over the wire; every split moves bytes,
    each process receiving what its peers send."""
    assert transport["1x4"][0]["sent_bytes"] == 0
    for tag in ("2x2", "4x1", "2x2-chaos"):
        rows = transport[tag]
        assert all(r["sent_bytes"] > 0 for r in rows), tag
        assert sum(r["sent_bytes"] for r in rows) \
            == sum(r["received_bytes"] for r in rows), tag


# ---------------------------------------------------------------------------
# bitwise output equivalence across process counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topology", ["2x2", "4x1"])
def test_ring_matmul_bitwise(baseline, two_proc, four_proc, topology):
    got = {"2x2": two_proc, "4x1": four_proc}[topology]
    assert _cases(got)["ring_matmul"]["digests"] == \
        _cases(baseline)["ring_matmul"]["digests"]


def test_minimod_bitwise(baseline, two_proc, four_proc):
    base = _cases(baseline)["minimod"]
    for results in (two_proc, four_proc):
        got = _cases(results)["minimod"]
        for tag in base:
            for key in ("digest", "energy", "z_extents", "puts", "put_bytes",
                        "byte_parity", "region_sizes", "alloc_counts",
                        "fences", "window_bytes"):
                assert got[tag][key] == base[tag][key], (tag, key)


def test_in_run_oracle_agreement(baseline, two_proc, four_proc):
    """Within every run the fused and host rings equal the all-gather
    oracle and fused Minimod equals host Minimod, exactly."""
    for results in (baseline, two_proc, four_proc):
        c = _cases(results)
        assert c["ring_matmul"]["fused_eq_ref"]
        assert c["ring_matmul"]["digests"]["host"] == \
            c["ring_matmul"]["digests"]["ref"]
        assert c["minimod"]["fused"]["digest"] == \
            c["minimod"]["host"]["digest"]


def test_card_routes_per_topology(baseline, two_proc, four_proc):
    """The routes the card takes, forced on the CPU: one launch of the
    fused ring and the carried step over the whole ring in one process,
    the ring step by step and the carried step over each process's box
    across processes — outputs and logs bit for bit the unforced ones."""
    for results, ring, step in ((baseline, "kernel", "carried"),
                                (two_proc, "stepwise", "carried_part"),
                                (four_proc, "stepwise", "carried_part")):
        c = _cases(results)
        routed = c["ring_matmul"]["routed"]
        assert routed["routes"] == {"ring": {ring: 1}, "step": {}}
        assert routed["digest"] == c["ring_matmul"]["digests"]["fused"]
        assert routed["logical_digest"] == \
            _cases(baseline)["ring_matmul"]["routed"]["logical_digest"]
        mm = c["minimod"]
        assert mm["overlap"]["overlapped"]
        assert mm["overlap_routed"]["routes"] == {"ring": {},
                                                  "step": {step: 2}}
        for key in ("digest", "puts", "put_bytes", "fences", "window_bytes"):
            assert mm["overlap_routed"][key] == mm["overlap"][key], key


# ---------------------------------------------------------------------------
# log parity: rank-vs-rank within a run, logical across runs
# ---------------------------------------------------------------------------


def test_rank_vs_rank_log_parity(baseline, two_proc, four_proc):
    """gather_stats rows are identical on every process: same call
    counts, byte counts, tracker totals, PGAS regions."""
    for results in (baseline, two_proc, four_proc):
        for case, c in _cases(results).items():
            if "rank_parity" in c:
                assert c["rank_parity"], case


def test_logical_logs_identical_across_process_counts(
        baseline, two_proc, four_proc):
    base = _cases(baseline)
    for results in (two_proc, four_proc):
        got = _cases(results)
        for case in base:
            if "logical_digest" in base[case]:
                assert got[case]["logical_digest"] == \
                    base[case]["logical_digest"], case


def test_ompccl_vs_tracker_byte_parity(baseline, two_proc, four_proc):
    """The OMPCCL put byte log equals the RMATracker window totals for the
    windowed paths (pgas moves nothing: 0 == 0; Minimod's fused runs), in
    every topology, and every parity flag agrees across process counts."""
    base_flags = None
    for results in (baseline, two_proc, four_proc):
        c = _cases(results)
        assert c["pgas"]["byte_parity"]
        for tag in ("fused", "weighted", "overlap", "overlap_routed"):
            assert c["minimod"][tag]["byte_parity"], tag
        flags = {case: r.get("byte_parity") for case, r in c.items()}
        flags["minimod"] = {t: r["byte_parity"]
                            for t, r in c["minimod"].items()}
        if base_flags is None:
            base_flags = flags
        assert flags == base_flags


def test_pgas_mapping_table_globally_consistent(baseline, two_proc,
                                                four_proc):
    base = _cases(baseline)["pgas"]
    assert base["sym_b_offsets_identical"]
    assert base["oversize_raises"]
    for results in (two_proc, four_proc):
        got = _cases(results)["pgas"]
        # coordinated allocation lands the identical table at any scale
        assert got["table"] == base["table"]
        assert got["table_digest"] == base["table_digest"]
        assert got["alloc_counts"] == base["alloc_counts"]
        assert got["rag_offsets"] == base["rag_offsets"]
        assert got["rag_local_sizes"] == base["rag_local_sizes"]
        assert got["sym_b_offsets_identical"]
        assert got["oversize_raises"]


# ---------------------------------------------------------------------------
# every topology against the single-process port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topology", ["1x4", "2x2", "4x1"])
def test_topology_equals_single_process_port(single, baseline, two_proc,
                                             four_proc, topology):
    """Each case's outputs and logs, bit for bit the port's in one process
    with no job joined (after the JSON round trip the workers' results
    took).  ``logs_digest`` digests the list of every process's snapshot,
    so it equals the one-process run's only at 1x4; each process's own
    snapshot is held by ``logical_digest`` and ``rank_parity``.  The card's
    routes differ by topology by design
    (``test_card_routes_per_topology``)."""
    got = _cases({"1x4": baseline, "2x2": two_proc,
                  "4x1": four_proc}[topology])
    want = json.loads(json.dumps(single))

    def strip(tree):
        if isinstance(tree, dict):
            return {k: strip(v) for k, v in tree.items()
                    if topology == "1x4"
                    or k not in ("logs_digest", "routes")}
        return tree

    for case in COMPUTE_CASES:
        assert strip(got[case]) == strip(want[case]), case


# ---------------------------------------------------------------------------
# the single-process port against the reference (in this process, CPU)
# ---------------------------------------------------------------------------


def test_single_process_ring_matches_reference():
    """Tolerance: f32 products to 1e-4 of the product's scale
    (``tests/test_torch_ring_matmul.py``: both sum in f32, in another
    order); the call and byte logs equal."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.core.compat import make_mesh, shard_map
    from repro.core.context import DiompContext as JContext
    from repro.core.context import use_default as j_use_default
    from repro.core.groups import DiompGroup as JGroup
    from repro.kernels.ring_matmul.ops import ring_allgather_matmul as j_ring
    from repro.kernels.ring_matmul.ref import ring_allgather_matmul_ref as j_ref

    out, _, ctx = ring_matmul_outputs()
    (A, B), _ = _ring_inputs(_ring_mesh())
    mesh = make_mesh((N_RANKS,), ("x",), axis_types="auto")
    group = JGroup(("x",), name="ring")
    jctx = JContext(mesh=mesh, segment_bytes=1 << 20)
    want = {}
    with j_use_default(jctx):
        for impl in ("fused", "host"):
            f = jax.jit(shard_map(
                lambda a, b, impl=impl: j_ring(a, b, group, impl=impl),
                mesh=mesh, in_specs=(P("x", None), P(None, "x")),
                out_specs=P(None, "x")))
            want[impl] = np.asarray(f(jnp.asarray(A), jnp.asarray(B)))
        r = jax.jit(shard_map(lambda a, b: j_ref(a, b, group), mesh=mesh,
                              in_specs=(P("x", None), P(None, "x")),
                              out_specs=P(None, "x")))
        want["ref"] = np.asarray(r(jnp.asarray(A), jnp.asarray(B)))
    scale = np.abs(A.astype(np.float64) @ B).max()
    for key, w in want.items():
        assert out[key].shape == w.shape
        assert np.abs(out[key].astype(np.float64) - w).max() <= 1e-4 * scale
    assert ctx.stats() == jctx.stats()
    assert ctx.byte_stats() == jctx.byte_stats()


def test_single_process_minimod_matches_reference():
    """Tolerance: fields to 3e-6 absolute, energies to a relative 1e-5
    (``tests/test_torch_minimod.py``); every counter equal."""
    from repro.apps.minimod import run_minimod as j_run_minimod

    runs, _ = minimod_runs()
    for tag, kw in MINIMOD_RUNS.items():
        want = j_run_minimod(steps=2, nz=N_RANKS, ny=1, **kw)
        got = runs[tag]
        for attr in ("puts", "put_bytes", "tracker_puts", "tracker_put_bytes",
                     "fences", "window_bytes", "region_sizes",
                     "alloc_counts", "z_extents"):
            assert getattr(got, attr) == getattr(want, attr), (tag, attr)
        np.testing.assert_allclose(got.field.numpy(), want.field, atol=3e-6)
        assert got.energy == pytest.approx(want.energy, rel=1e-5)


# ---------------------------------------------------------------------------
# determinism across processes
# ---------------------------------------------------------------------------

DIGESTS = ("fault_digest", "rng_digest", "trace_digest")


def test_determinism_digests_match_across_runs(baseline, two_proc,
                                               four_proc):
    base = baseline[0]["cases"]["determinism"]
    for results in (two_proc, four_proc):
        got = results[0]["cases"]["determinism"]
        for key in DIGESTS:
            assert got[key] == base[key], key
        assert got["injected_counts"] == base["injected_counts"]


def test_determinism_digests_match_across_ranks(two_proc, four_proc):
    for results in (two_proc, four_proc):
        rows = [r["cases"]["determinism"] for r in results]
        for key in DIGESTS:
            assert len({row[key] for row in rows}) == 1, key


def test_fault_plan_actually_fired(baseline):
    """p = 0.3 over 240 dispatches: the schedule injects faults (the
    digest would trivially agree on an empty stream)."""
    counts = baseline[0]["cases"]["determinism"]["injected_counts"]
    assert sum(counts.values()) > 0


# ---------------------------------------------------------------------------
# chaos across processes
# ---------------------------------------------------------------------------


def _chaos(chaos_two):
    return chaos_two[0]["cases"]["chaos_ring"]


def test_chaos_armed_and_recovered(chaos_two):
    c = _chaos(chaos_two)
    assert c["chaos"]["armed"]
    assert c["chaos"]["injected_total"] > 0      # the dice actually rolled
    assert c["chaos"]["unrecovered"] == 0        # every fault retried out
    assert c["retry_total"] > 0                  # retries hit the books


def test_chaos_outputs_bitwise_equal_calm_run(chaos_two, two_proc):
    c = _chaos(chaos_two)
    calm = two_proc[0]["cases"]["ring_matmul"]
    assert c["digests"] == calm["digests"]
    assert c["fused_eq_ref"]


def test_chaos_invariant_logical_logs(chaos_two, two_proc):
    """Retry traffic lands in the retry books only: the logical call/byte
    logs and RMA tracker totals match the calm run exactly."""
    c = _chaos(chaos_two)
    calm = two_proc[0]["cases"]["ring_matmul"]
    assert c["logical_digest"] == calm["logical_digest"]
    assert calm["retry_total"] == 0


def test_chaos_rank_parity(chaos_two):
    """Deterministic injection: every process rolls the same faults at the
    same call indices, so the full result blob agrees rank against rank."""
    c = _chaos(chaos_two)
    assert c["rank_parity"]
    assert len({_strip_pid(r) for r in chaos_two}) == 1


if __name__ == "__main__":
    sys.exit(main())
