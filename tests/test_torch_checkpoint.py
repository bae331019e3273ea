"""The port's checkpoints, straggler monitor and data pipeline.

The port of ``tests/test_checkpoint_recovery.py`` (torn writes, corrupt
manifests, orphan reclaim: a checkpoint is either complete and verified or
it does not exist) and of the checkpoint, straggler and pipeline tests of
``tests/test_train_serve.py``, on the port's ``CheckpointManager``; plus
the on-disk layout shared with the reference: a checkpoint the reference
wrote (bf16 parameters included) restores in the port bit for bit, one the
port wrote restores in the reference, and a trained state restores onto
another mesh (the elastic re-shard) and trains on bit for bit.
"""

import json
import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as JCheckpointManager

from repro_torch import configs
from repro_torch.core.context import DiompContext, use_default
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.interop import stack_shards
from repro_torch.launch.mesh import RankMesh, make_smoke_mesh
from repro_torch.launch.train import from_global, to_global
from repro_torch.models import api
from repro_torch.models import schema as sch
from repro_torch.models.config import ParallelCtx
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optim import adamw
from repro_torch.train.step import build_train_step, opt_state_specs
from repro_torch.train.straggler import StragglerMonitor


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return ({"w": torch.from_numpy(rng.randn(8, 4).astype(np.float32)),
             "b": torch.from_numpy(rng.randn(4).astype(np.float32))},
            {"m": torch.zeros(8, 4)})


def _save_steps(ckpt, steps):
    for s in steps:
        params, opt = _params(s)
        ckpt.save(s, params, opt, blocking=True)


def _step_dir(d, step):
    return os.path.join(d, f"step_{step:08d}")


def _shard_files(d, step):
    sd = _step_dir(d, step)
    return [os.path.join(sd, f) for f in os.listdir(sd) if f.endswith(".npy")]


def test_truncated_shard_is_skipped_by_latest(tmp_path):
    d = str(tmp_path)
    ckpt = CheckpointManager(d, keep=5)
    _save_steps(ckpt, [1, 2])
    assert ckpt.latest() == 2
    victim = _shard_files(d, 2)[0]
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    assert ckpt.verify_step(2) is False
    assert ckpt.verify_step(1) is True
    assert ckpt.latest() == 1
    assert ckpt.latest(verify=False) == 2
    step, params, _opt, _extra = ckpt.restore()
    assert step == 1
    assert torch.equal(params["w"], _params(1)[0]["w"])


def test_restore_damaged_step_raises_clear_error(tmp_path):
    d = str(tmp_path)
    ckpt = CheckpointManager(d, keep=5)
    _save_steps(ckpt, [3])
    with open(_shard_files(d, 3)[0], "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError, match="damaged.*checksum mismatch"):
        ckpt.restore(step=3)


def test_restore_unreadable_manifest_raises(tmp_path):
    d = str(tmp_path)
    ckpt = CheckpointManager(d, keep=5)
    _save_steps(ckpt, [4])
    with open(os.path.join(_step_dir(d, 4), "manifest.json"), "w") as f:
        f.write("{ not json")
    with pytest.raises(IOError, match="unreadable manifest"):
        ckpt.restore(step=4)
    assert ckpt.latest() is None


def test_tampered_manifest_checksum_detected(tmp_path):
    d = str(tmp_path)
    ckpt = CheckpointManager(d, keep=5)
    _save_steps(ckpt, [5])
    mpath = os.path.join(_step_dir(d, 5), "manifest.json")
    with open(mpath) as f:
        meta = json.load(f)
    meta["files"][next(iter(meta["files"]))]["sha256"] = "0" * 64
    with open(mpath, "w") as f:
        json.dump(meta, f)
    assert ckpt.verify_step(5) is False
    with pytest.raises(IOError, match="refusing to load garbage"):
        ckpt.restore(step=5)


def test_orphaned_tmp_dirs_reclaimed_on_startup(tmp_path):
    d = str(tmp_path)
    ckpt = CheckpointManager(d, keep=5)
    _save_steps(ckpt, [1])
    orphan = os.path.join(d, "step_00000009.tmp")
    os.makedirs(orphan)
    with open(os.path.join(orphan, "junk.npy"), "wb") as f:
        f.write(b"partial")
    fresh = CheckpointManager(d, keep=5)
    assert not os.path.exists(orphan)
    assert fresh.steps() == [1]
    assert fresh.latest() == 1


def test_crash_between_saves_falls_back_across_gap(tmp_path):
    d = str(tmp_path)
    ckpt = CheckpointManager(d, keep=5)
    _save_steps(ckpt, [1, 2, 3])
    with open(_shard_files(d, 3)[0], "r+b") as f:
        f.truncate(1)
    shutil.rmtree(_step_dir(d, 2))
    assert ckpt.latest() == 1
    assert ckpt.restore()[0] == 1


def test_checkpoint_corruption_detected(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"w": torch.ones(4, 4)}, {"v": np.zeros(3)}, blocking=True)
    d = _step_dir(str(tmp_path), 1)
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    with open(os.path.join(d, victim), "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad")
    with pytest.raises(IOError):
        ckpt.restore()


def test_checkpoint_gc_keeps_latest(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ckpt.save(s, {"w": torch.full((2,), float(s))}, {}, blocking=True)
    assert ckpt.steps() == [3, 4]


def _mixed_tree(seed):
    rng = np.random.RandomState(seed)
    bf = rng.randn(6, 5).astype(np.float32)
    return ({"layers/w": bf, "norm": rng.randn(5).astype(np.float32)},
            {"m": {"layers/w": rng.randn(6, 5).astype(np.float32)},
             "step": np.asarray(3, np.int32)})


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference writes (its bf16 leaf as uint16 bits), the port reads
    the same bits, and the other way round."""
    params, opt = _mixed_tree(11)
    jparams = {"layers/w": jnp.asarray(params["layers/w"], jnp.bfloat16),
               "norm": params["norm"]}
    JCheckpointManager(str(tmp_path / "ref"), keep=2).save(
        7, {k: np.asarray(v) for k, v in jparams.items()}, opt,
        extra={"arch": "x"}, blocking=True)
    step, p, o, extra = CheckpointManager(str(tmp_path / "ref")).restore()
    assert step == 7 and extra == {"arch": "x"}
    assert p["layers/w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        p["layers/w"].float().numpy(),
        np.asarray(jparams["layers/w"].astype(jnp.float32)))
    np.testing.assert_array_equal(p["norm"].numpy(), params["norm"])
    np.testing.assert_array_equal(o["m"]["layers/w"].numpy(),
                                  opt["m"]["layers/w"])
    assert int(o["step"]) == 3
    # the port writes; the reference reads the same bits and file names
    CheckpointManager(str(tmp_path / "port")).save(7, p, o, blocking=True)
    step, jp, jo, _ = JCheckpointManager(str(tmp_path / "port")).restore()
    assert step == 7
    np.testing.assert_array_equal(np.asarray(jp["layers/w"], np.float32),
                                  p["layers/w"].float().numpy())
    assert sorted(os.listdir(_step_dir(str(tmp_path / "port"), 7))) == \
        sorted(os.listdir(_step_dir(str(tmp_path / "ref"), 7)))


def _trainer(mesh, cfg):
    ctx = ParallelCtx.from_mesh(mesh, remat=True)
    opt = adamw(lambda s: torch.tensor(5e-3))
    step = build_train_step(cfg, mesh, ctx, opt, donate=False)
    _, bspecs = api.batch_structs(cfg, mesh, 8, 16, dp_axes=ctx.dp_axes)
    src = SyntheticLM(cfg, 8, 16, seed=17)

    def batch(i):
        return {k: stack_shards(v, mesh, bspecs[k])
                for k, v in src.batch_at(i).items()}
    return opt, step, batch


@pytest.mark.parametrize("mesh2", [make_smoke_mesh(8),
                                   RankMesh(("data", "model"), (4, 2))],
                         ids=["same-mesh", "reshard"])
def test_save_restore_then_step_is_bitwise_the_run(tmp_path, mesh2):
    """Two steps, a checkpoint, a third step; the checkpoint restored (on
    the same mesh, or re-sharded onto data 4 x model 2) and the third step
    taken again: bit for bit the uninterrupted run's parameters and
    optimizer state (on the same mesh; on the other mesh the restored
    state is bit for bit the saved one)."""
    cfg = configs.get_reduced("stablelm-3b")
    mesh = make_smoke_mesh(8)
    pspecs = sch.partition_specs(cfg, mesh)
    ospecs = opt_state_specs(cfg, mesh, "adamw")
    ckpt = CheckpointManager(str(tmp_path))
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        opt, step, batch = _trainer(mesh, cfg)
        p = sch.init_params(cfg, mesh, torch.Generator().manual_seed(0),
                            device="cpu")
        st = opt.init(p)
        for i in range(2):
            p, st, _ = step(p, st, batch(i), i)
        ckpt.save(2, to_global(p, pspecs, mesh), to_global(st, ospecs, mesh),
                  blocking=True)
        p_a, st_a, _ = step(p, st, batch(2), 2)
    assert ckpt.verify_step(2) and ckpt.latest() == 2
    s, gp, gs, _ = ckpt.restore()
    assert s == 2
    specs2 = sch.partition_specs(cfg, mesh2)
    ospecs2 = opt_state_specs(cfg, mesh2, "adamw")
    p_r = from_global(gp, specs2, mesh2, "cpu")
    st_r = from_global(gs, ospecs2, mesh2, "cpu")
    assert all(p_r[n].dtype == p[n].dtype for n in p)
    back = to_global(p_r, specs2, mesh2)
    assert all(torch.equal(back[n], gp[n]) for n in gp)
    if mesh2 != mesh:
        with use_default(DiompContext(mesh=mesh2, device="cpu")):
            _, step2, batch2 = _trainer(mesh2, cfg)
            _, _, m = step2(p_r, st_r, batch2(2), 2)
        assert np.isfinite(float(m["loss"].reshape(-1)[0]))
        return
    with use_default(DiompContext(mesh=mesh, device="cpu")):
        p_b, st_b, _ = step(p_r, st_r, batch(2), 2)
    for n in p_a:
        assert torch.equal(p_a[n], p_b[n]), n
        for m in ("m", "v"):
            assert torch.equal(st_a[m][n], st_b[m][n]), (m, n)


def test_straggler_monitor_boost_and_evict():
    boosts, evicts = [], []
    m = StragglerMonitor(threshold=2.0, evict_after=3,
                         on_prefetch_boost=boosts.append,
                         on_evict=lambda: evicts.append(1))
    for i in range(5):
        m.step_end(i, dt=1.0)
    m.step_end(5, dt=5.0)
    m.step_end(6, dt=5.0)
    assert boosts == [1, 2]
    m.step_end(7, dt=6.0)
    assert evicts == [1]
    m.step_end(8, dt=1.0)
    assert m.consecutive == 0
    assert m.escalate(9, "rank-death") == "evict" and evicts == [1, 1]
    m.reset()
    assert m.ewma is None


def test_data_pipeline_deterministic_and_sharded():
    cfg = configs.get_reduced("stablelm-3b")
    a = SyntheticLM(cfg, 4, 8, seed=7, shard=0)
    b = SyntheticLM(cfg, 4, 8, seed=7, shard=0)
    c = SyntheticLM(cfg, 4, 8, seed=7, shard=1)
    np.testing.assert_array_equal(a.batch_at(5)["tokens"],
                                  b.batch_at(5)["tokens"])
    assert not np.array_equal(a.batch_at(5)["tokens"],
                              c.batch_at(5)["tokens"])
    pf = Prefetcher(a, depth=3)
    assert [pf.get()[0] for _ in range(5)] == [0, 1, 2, 3, 4]
    pf.boost(2)
    assert pf.depth == 5


def test_launcher_elastic_eviction_loop(tmp_path, monkeypatch):
    """A timing escalation closes the loop: checkpoint, shrink the mesh to
    half its ranks, restore from the latest verified step, train on."""
    from repro_torch.core.context import reset_default_context
    from repro_torch.launch import train as launcher

    real = StragglerMonitor.step_end

    def slow_from_4(self, step, dt=None):
        return real(self, step, dt=1.0 if step < 4 else 10.0)

    monkeypatch.setattr(StragglerMonitor, "step_end", slow_from_4)
    try:
        run = launcher.main(["--arch", "glm4-9b", "--reduced", "--steps", "12",
                             "--batch", "8", "--seq", "16", "--device", "cpu",
                             "--checkpoint-dir", str(tmp_path),
                             "--checkpoint-every", "2"])
    finally:
        reset_default_context()
    assert run["restarts"] == 1
    assert run["mesh"].size == 4
    assert all(np.isfinite(run["losses"]))
