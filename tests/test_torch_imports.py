"""The port stands alone: importing every ``repro_torch`` module loads neither
JAX nor anything of the JAX package, no source of the port (or
``chip_smoke.py``) names them, and the entry points refuse to run on a
machine without a card unless the caller asks for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.configs.base import get_config
from repro_torch.launch import serve, train
from repro_torch.models import build_model

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert {"repro_torch.runtime.serving", "repro_torch.launch.serve",
            "repro_torch.launch.train", "repro_torch.optim.adamw",
            "repro_torch.runtime.trainer", "repro_torch.data.pipeline",
            "repro_torch.checkpoint.checkpointing", "repro_torch.runtime.fault_tolerance",
            "repro_torch.obs", "repro_torch.obs.trace", "repro_torch.obs.metrics",
            "repro_torch.obs.calibration", "repro_torch.obs.provenance",
            "repro_torch.obs.logging", "repro_torch.configs.minicpm3_4b",
            "repro_torch.configs.phi_3_vision_4_2b",
            "repro_torch.configs.seamless_m4t_large_v2", "repro_torch.configs.clex_paper",
            *(f"repro_torch.core.{m}" for m in (
                "hashrng", "topology", "routing", "simulator", "streaming", "torus_sim",
                "scenarios", "analysis", "sim_engine"))} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imports(path: Path):
    """(module, level) of every import statement in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, 0
        elif isinstance(node, ast.ImportFrom):
            yield node.module or "", node.level


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_name_no_jax_and_no_reference_module(path):
    rel = path.relative_to(PORT).parts if PORT in path.parents else ()
    for module, level in _imports(path):
        top = module.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {module}"
        # a relative import may not climb out of repro_torch into src/
        assert level <= len(rel), f"{path}: relative import escapes the package"


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("internlm2-1.8b", reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1"])
    train.main(["--reduced", "--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "8"])
    assert resolve_device("cpu").type == "cpu"
    assert build_model(cfg, device="cpu").device.type == "cpu"
