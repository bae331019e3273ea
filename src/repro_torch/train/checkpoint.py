"""Fault-tolerant checkpointing: async, atomic, resumable, elastic.

Design (DESIGN.md §6):

* **Async** — array serialization runs on the DiOMP StreamPool (the paper's
  bounded-concurrency host lanes), so training continues while bytes drain.
* **Atomic** — writes go to ``step_XXXX.tmp`` and are renamed only after
  every shard file + a checksum manifest are durable; a crash mid-write can
  never leave a readable-but-corrupt checkpoint.  *Durable* means fsynced:
  each shard file, the manifest, the tmp directory, and the parent
  directory around the rename — rename-without-fsync is not crash-safe
  (the rename can land while the data blocks are still in the page
  cache).  Orphaned ``.tmp`` directories from a crashed writer are
  garbage-collected on manager startup.
* **Resumable** — ``latest()`` finds the newest complete *and verified*
  step (a damaged step is skipped, never silently half-loaded); restore
  verifies checksums before any byte reaches a device and raises a clear
  error naming the damaged file.
* **Elastic re-shard** — arrays are saved in *global* layout; restore
  hands each one to a ``shard_fn`` that lays it out on whatever mesh the
  new job brings up (the port's stacked tensors,
  :func:`repro_torch.interop.stack_shards`), so a restart on a different
  mesh re-shards transparently (the placement is recomputed from the
  schema, not from the file).

The reference's ``repro/train/checkpoint.py`` on torch tensors, with its
on-disk layout kept file for file: one ``.npy`` a leaf (named by the
SHA-1 of its ``params|name`` / ``opt|m|name`` key), bfloat16 stored as
its uint16 bits with ``"dtype": "bfloat16"`` in the manifest, so a
checkpoint either package wrote restores in the other.  Leaves go in as
torch tensors or numpy arrays in the global layout and come back as CPU
torch tensors.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.streams import StreamPool

__all__ = ["CheckpointManager"]


def _fsync_dir(path: str) -> None:
    """fsync a directory entry (required for rename durability on POSIX);
    best-effort where the filesystem refuses directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as host bytes and its dtype name (bfloat16 as uint16 bits:
    numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _tree_to_flat(tree, prefix="") -> Dict[str, Tuple[np.ndarray, str]]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_tree_to_flat(v, f"{prefix}{k}|"))
    else:
        out[prefix.rstrip("|")] = _host(tree)
    return out


def _flat_to_tree(flat: Dict[str, np.ndarray]):
    tree: Dict = {}
    for key, val in flat.items():
        parts = key.split("|")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 pool: Optional[StreamPool] = None):
        self.dir = directory
        self.keep = keep
        self.pool = pool or StreamPool(max_active=4)
        os.makedirs(directory, exist_ok=True)
        self._pending = []
        # a crashed writer leaves step_XXXX.tmp behind; it can never become
        # a checkpoint (the rename is what commits), so reclaim the space
        for d in os.listdir(directory):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(directory, d), ignore_errors=True)

    # -- save -------------------------------------------------------------
    def save(self, step: int, params, opt_state, extra: Optional[dict] = None,
             *, blocking: bool = False):
        """Snapshot host-side, then drain asynchronously."""
        flat = _tree_to_flat({"params": params, "opt": opt_state})
        meta = {"step": step, "time": time.time(), "extra": extra or {},
                "files": {}}
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)

        def write_one(name: str, leaf) -> Tuple[str, str, str]:
            arr, dtype_name = leaf
            fn = hashlib.sha1(name.encode()).hexdigest()[:16] + ".npy"
            path = os.path.join(tmp, fn)
            with open(path, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())           # durable BEFORE the rename
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            return fn, digest, dtype_name

        futures = {name: self.pool.submit(write_one, name, leaf)
                   for name, leaf in flat.items()}

        def finalize():
            for name, fut in futures.items():
                fn, digest, dtype_name = fut.result()
                meta["files"][name] = {"file": fn, "sha256": digest,
                                       "dtype": dtype_name}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)                  # entries durable before commit
            os.replace(tmp, final)           # atomic commit
            _fsync_dir(self.dir)             # the rename itself durable
            self._gc()

        fut = self.pool.submit(finalize)
        self._pending.append(fut)
        if blocking:
            fut.result()
        return fut

    def wait(self):
        for f in self._pending:
            f.result()
        self._pending.clear()

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                    out.append(int(d[5:]))
        return sorted(out)

    def verify_step(self, step: int) -> bool:
        """True iff ``step``'s manifest parses and every shard file matches
        its recorded checksum — a crashed/corrupted step returns False."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                meta = json.load(f)
            for name, info in meta["files"].items():
                with open(os.path.join(d, info["file"]), "rb") as f:
                    if hashlib.sha256(f.read()).hexdigest() != info["sha256"]:
                        return False
        except (OSError, ValueError, KeyError, TypeError):
            return False
        return True

    def latest(self, *, verify: bool = True) -> Optional[int]:
        """The newest restorable step.  ``verify`` (default) checksums each
        candidate and *skips damaged steps* — a torn write of step N must
        fall back to step N-1, not take the whole run down."""
        for step in reversed(self.steps()):
            if not verify or self.verify_step(step):
                return step
        return None

    def restore(self, step: Optional[int] = None, *,
                shard_fn: Optional[Callable[[str, torch.Tensor],
                                            torch.Tensor]] = None):
        """Returns (step, params, opt_state, extra).

        ``shard_fn(name, tensor)`` lays each global tensor (on the CPU) out
        on the *current* mesh (elastic re-shard); identity if None.  A
        damaged step raises ``IOError`` naming the file — garbage never
        reaches a device.
        """
        if step is None:
            step = self.latest()
        if step is None:
            raise FileNotFoundError("no complete checkpoint found")
        d = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            raise IOError(
                f"checkpoint step {step} is damaged: unreadable manifest "
                f"({e}) — refusing to restore") from e
        flat = {}
        for name, info in meta["files"].items():
            path = os.path.join(d, info["file"])
            with open(path, "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != info["sha256"]:
                    raise IOError(
                        f"checkpoint step {step} is damaged: checksum "
                        f"mismatch for {name} ({info['file']}) — refusing "
                        "to load garbage")
            arr = np.load(path)
            if info.get("dtype") == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            flat[name] = shard_fn(name, t) if shard_fn else t
        tree = _flat_to_tree(flat)
        return step, tree["params"], tree["opt"], meta.get("extra", {})
