"""Rules of the port: it imports no JAX and nothing of the JAX package,
it imports cleanly with JAX blocked, and its entry points run on the card
unless the caller asks for the CPU."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [name for name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path} imports {bad}"


def test_rule_covers_every_subpackage():
    covered = {p.relative_to(PORT).parts[0] for p in SOURCES
               if p.is_relative_to(PORT)}
    assert {"core", "kernels", "models", "serve", "configs", "distributed",
            "launch", "apps"} <= covered


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not [k for k in sys.modules if k.startswith('jax')"
        " and sys.modules[k] is not None]\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import configs
    from repro_torch.apps.minimod import run_minimod
    from repro_torch.core.context import DiompContext, init
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import rwkv, ssm
    from repro_torch.models.config import ParallelCtx
    from repro_torch.serve import step
    from repro_torch.serve.engine import ServeEngine
    mesh = make_smoke_mesh(8)
    ctx = ParallelCtx.from_mesh(mesh)
    rw = configs.get_reduced("rwkv6-7b")
    zb = configs.get_reduced("zamba2-1-2b")
    # the recurrent families' serving units: their state and a built
    # prefill or decode step take the active context's device, which is
    # the card unless the caller opens a CPU context
    steps = [build(cfg, mesh, ctx, B=4, **{size: 16})
             for cfg in (rw, zb)
             for build, size in ((step.build_prefill_step, "S_cache"),
                                 (step.build_decode_step, "S"))]
    for call in (DiompContext, init,
                 lambda: run_minimod(grid=(16, 8, 8), nz=2, steps=1),
                 lambda: ServeEngine(configs.get_reduced("glm4-9b"), mesh,
                                     ParallelCtx.from_mesh(mesh), {}),
                 lambda: serve.main([]),
                 lambda: rwkv.rwkv_init_state(rw, ctx, 1),
                 lambda: ssm.zamba_init_state(zb, ctx, 1, 16),
                 *[lambda s=s: s({}, None, {}) for s in steps]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert DiompContext(device="cpu").device.type == "cpu"


def test_serve_launcher_defaults_to_the_card(capsys):
    """``python -m repro_torch.launch.serve`` takes the card unless
    ``--device cpu`` is passed (the raise is in the test above); on the CPU
    it serves every request."""
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "2", "--max-new", "2"])
    out = capsys.readouterr().out
    assert "served 2/2 requests" in out and "on cpu" in out


def test_chip_smoke_fails_without_the_port(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout == ""


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
