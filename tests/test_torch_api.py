"""API parity: every module of the JAX package that the port has ported
exports, in its ``__all__``, every name the reference's exports, but for
the exceptions listed here with the ROADMAP item each waits for; the
modules the port has not ported are exactly the listed ones.  The faults
C1-C6 of ROADMAP were all of this kind (a missing name or a name with
another meaning); the signatures are held in ``tests/test_torch_serving.py``
(``_SIGNATURES``).  Also the names C5 and C6 added, against the
reference: ``configs.base.registry`` and ``ParallelConfig``,
``models.layers.layer_norm``, ``models.ssm.ssd_chunked`` (whose result
does not depend on ``head_group``) and ``AdamWConfig.error_feedback``."""

import dataclasses
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

# names of a reference module's __all__ the port's counterpart lacks, each
# with where it is to come from
EXCEPTIONS = {
    "configs.base": {"ShapeConfig": "A14", "SHAPES": "A14"},
    "models.layers": {"Initializer": "none: the port's initialisers take a torch.Generator"},
}
# reference modules without a counterpart yet, and the ROADMAP item of each
UNPORTED = {
    "launch.dryrun": "A14",
    "launch.specs": "A14",
    "launch.jax_compat": "none: the JAX version seam",
    "runtime.orchestrator": "A12",
    "runtime.autoscale": "A12",
    "runtime.serving_elastic": "A12",
}


# modules of the port without a counterpart in the JAX package, and why
PORT_ONLY = {
    "bridge": "weights, caches and optimizer state across the packages",
    "device": "the port's device choice",
    "tree": "the port's param trees (the reference has jax.tree)",
    "core.cost_model": "CollectiveCostModel, re-exported from core.collectives",
    "core.threefry": "the port's copy of the jax.random draws it repeats (the Valiant shift)",
    "kernels.build": "the build of the hand-written CUDA kernels",
}


def _reference_modules() -> list[str]:
    src = ROOT / "src" / "repro"
    names = []
    for path in sorted(src.rglob("*.py")):
        parts = path.relative_to(src).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        names.append(".".join(parts))
    return names


def _ported(name: str) -> bool:
    rel = Path(*name.split(".")) if name else Path()
    port = ROOT / "src" / "repro_torch"
    return (port / rel.with_suffix(".py")).exists() or (port / rel / "__init__.py").exists()


PORTED = [m for m in _reference_modules() if _ported(m)]


def test_the_unported_modules_are_the_listed_ones():
    assert {m for m in _reference_modules() if not _ported(m)} == set(UNPORTED)
    assert {"core.collectives", "launch.mesh", "runtime.trainer"} <= set(PORTED)


def test_the_port_only_modules_are_the_listed_ones():
    def modules(root: Path) -> set[str]:
        return {".".join(p.relative_to(root).with_suffix("").parts)
                for p in root.rglob("*.py") if p.name != "__init__.py"}

    src = ROOT / "src"
    assert modules(src / "repro_torch") - modules(src / "repro") == set(PORT_ONLY)


@pytest.mark.parametrize("module", PORTED, ids=lambda m: m or "repro")
def test_ported_module_exports_the_references_names(module):
    ref = importlib.import_module("repro" + (f".{module}" if module else ""))
    port = importlib.import_module("repro_torch" + (f".{module}" if module else ""))
    missing = set(getattr(ref, "__all__", ())) - set(getattr(port, "__all__", ()))
    assert missing == set(EXCEPTIONS.get(module, {})), missing
    for name in getattr(port, "__all__", ()):
        assert hasattr(port, name), f"{module}.__all__ names {name}, which it lacks"


def test_registry_and_parallel_config_equal_the_reference():
    from repro.configs import base as jb
    from repro_torch.configs import base as tb

    reg, jreg = tb.registry(), jb.registry()
    assert list(reg) == list(jreg) == tb.ARCH_IDS
    for arch in reg:
        assert dataclasses.asdict(reg[arch]()) == dataclasses.asdict(jreg[arch]()), arch
    assert dataclasses.asdict(tb.ParallelConfig()) == dataclasses.asdict(jb.ParallelConfig())
    assert [f.name for f in dataclasses.fields(tb.ParallelConfig)] == [
        f.name for f in dataclasses.fields(jb.ParallelConfig)]


def test_adamw_config_has_the_reference_fields_and_passes_err_through():
    from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(AdamWConfig) == fields(JaxAdamWConfig)
    assert fields(AdamWConfig)[-1] == ("error_feedback", False)
    p = {"w": torch.ones(3, 2)}
    state = adamw_init(p, AdamWConfig(error_feedback=True))
    err = torch.arange(3.0)
    state["err"] = {"w": err}
    _, state, _ = adamw_update(p, {"w": torch.full((3, 2), 0.5)}, state, AdamWConfig(),
                               {"w": True})
    assert state["err"]["w"] is err and torch.equal(err, torch.arange(3.0))


def test_layer_norm_equals_the_reference():
    from repro.models.layers import layer_norm as jax_layer_norm
    from repro_torch.models.layers import layer_norm

    rng = np.random.default_rng(0)
    x, scale, bias = (rng.normal(size=s).astype(np.float32) for s in ((2, 5, 16), (16,), (16,)))
    want = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 1e-5))
    got = layer_norm(*map(torch.from_numpy, (x, scale, bias)), 1e-5).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    xb = torch.from_numpy(x).bfloat16()
    assert layer_norm(xb, torch.from_numpy(scale), torch.from_numpy(bias), 1e-5).dtype == \
        torch.bfloat16


def _ssd_inputs(seed=0, b=2, s=32, h=6, p=4, n=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32) * 0.5
    a = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    bb, cc = (rng.normal(size=(b, s, n)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, a, bb, cc, h0


@pytest.mark.parametrize("head_group", [1, 2, 4, 8])
def test_ssd_chunked_equals_the_reference_and_ignores_head_group(head_group):
    """Within 1e-5 of the reference's ``ssd_chunked`` (fp32; 6 heads, so
    groups of 4 fall back to 3 as in the reference), and bit-identical
    across head groups."""
    from repro.models.ssm import ssd_chunked as jax_ssd_chunked
    from repro_torch.models.ssm import ssd_chunked

    x, dt, a, bb, cc, h0 = _ssd_inputs()
    yj, hj = jax_ssd_chunked(*map(jnp.asarray, (x, dt, a, bb, cc)), chunk=8,
                             h0=jnp.asarray(h0), head_group=head_group)
    t = [torch.from_numpy(v) for v in (x, dt, a, bb, cc, h0)]
    y, h = ssd_chunked(*t[:5], chunk=8, h0=t[5], head_group=head_group)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=1e-5, atol=1e-5)
    y1, h1 = ssd_chunked(*t[:5], chunk=8, h0=t[5], head_group=1)
    assert torch.equal(y, y1) and torch.equal(h, h1)


def test_jitted_step_donates_or_leaves_the_callers_state_as_it_was():
    """``jitted_step()`` is the in-place step; ``jitted_step(donate=False)``
    gives the same result from copies and leaves the caller's params and
    optimizer state bit-identical, as the reference's does."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("internlm2-1.8b", reduced=True), n_layers=1,
                              compute_dtype="float32")
    trainer = Trainer(build_model(cfg, device="cpu"), AdamWConfig(lr=1e-3))
    params, opt = trainer.init(torch.Generator().manual_seed(0))
    batch = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=2).global_batch_arrays(0)
    before = [t.clone() for t in tree_leaves((params, opt)) if isinstance(t, torch.Tensor)]
    p1, o1, m1 = trainer.jitted_step(donate=False)(params, opt, batch)
    after = [t for t in tree_leaves((params, opt)) if isinstance(t, torch.Tensor)]
    assert opt["step"] == 0 and all(torch.equal(a, b) for a, b in zip(before, after))
    assert all(t.requires_grad for t in tree_leaves(p1)) and o1["step"] == 1
    p2, o2, m2 = trainer.jitted_step()(params, opt, batch)
    assert p2 is params and o2 is opt and float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
