"""The port stands alone: it loads neither JAX nor the ``repro`` package,
and its entry points run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def _smoke_imports():
    tree = ast.parse(SMOKE.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return sorted(names)


def test_port_imports_load_no_jax_and_no_repro():
    mods = _port_modules() + _smoke_imports()
    assert "repro_torch.core.archival.pipeline" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print(bad)\n"
        "raise SystemExit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports_of(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_jax_or_repro(path):
    for name in _imports_of(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device=`` an entry point runs on the card; where there is
    none it raises instead of running on the CPU."""
    from repro_torch.core.archival import pipeline
    from repro_torch.core.crypto import rlwe
    from repro_torch.kernels import resolve_device
    from repro_torch.kernels.seal import ops as seal_ops

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rlwe.keygen(g)
    pub, s = rlwe.keygen(g, device="cpu")
    flats = [torch.zeros(100, dtype=torch.int8)]
    cfg = pipeline.ArchiveConfig(codec_name="none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.seal_payload_stripe(pub, flats, [{"n_i8": 100}], g, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seal_ops.seal_stripe(flats, torch.zeros((1, 8), dtype=torch.uint32),
                             torch.zeros((1, 3), dtype=torch.uint32))
    stripe = pipeline.seal_payload_stripe(pub, flats, [{"n_i8": 100}], g, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.restore_stripe_payloads(s, stripe, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.recompute_stripe_parity(stripe)
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_raise_off_cuda_for_foreign_devices():
    """A wrapper takes the plain path only for CPU tensors; a tensor on
    another device is refused, never silently computed elsewhere."""
    from repro_torch.kernels import as_tensor
    from repro_torch.kernels.seal.seal import seal_stripe_kernel

    meta = torch.empty((1, 0), device="meta")
    with pytest.raises(ValueError, match="shape"):
        seal_stripe_kernel(torch.empty((1, 8, 100), dtype=torch.int8, device="meta"),
                           meta, meta, meta, meta)
    assert as_tensor([1, 2], torch.int32, torch.device("cpu")).tolist() == [1, 2]
