"""Training the ``jamba-v0.1-52b`` hybrid (Mamba-2 and attention layers, MoE
FFNs on the odd layers) in the port against the JAX package, on ``REDUCED``
(8 layers, d_model 128) in fp32 on the CPU: five ``Trainer`` steps against
the JAX ``Trainer``, and the train launcher on the hybrid.  ``train_loss``
and its gradients are held in ``tests/test_torch_hybrid.py``, the decay mask
in ``tests/test_torch_train.py``.

Weights are made by the JAX package and cross the bridge.  Tolerance: the
loss and the gradient norm of each step 1e-4 relative, as the MoE curve of
``tests/test_torch_train.py``, under its rule: each port step starts from
the reference's params and optimizer state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.runtime.trainer import Trainer as JaxTrainer
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer
from repro_torch.tree import tree_map

# two intra-op threads per process, as tests/test_torch_train.py sets them
torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"


def test_hybrid_trainer_loss_curve_matches_jax():
    """Five steps of ``SyntheticLM`` batches through both trainers; both
    report the cross entropy (the minimised loss adds 0.01 x the MoE layers'
    load-balancing loss).  As for granite-moe, a routing decision near a tie
    can flip between the frameworks' roundings once the weights part, so
    each port step takes the reference's params and optimizer state; each
    step's loss, gradient norm and update are the port's own, and the
    optimizer step comes back a Python int."""
    cfg_j = dataclasses.replace(jax_get_config(ARCH, reduced=True), compute_dtype="float32")
    cfg_t = dataclasses.replace(get_config(ARCH, reduced=True), compute_dtype="float32")
    mj, mt = jax_build_model(cfg_j), build_model(cfg_t, device="cpu")
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20)
    step_j = JaxTrainer(mj, jax_adamw.AdamWConfig(**kw)).jitted_step(donate=False)
    trainer = Trainer(mt, adamw.AdamWConfig(**kw))
    pipe = SyntheticLM(vocab=cfg_t.vocab, seq_len=64, global_batch=4, seed=0)
    params_j = jax.tree.map(np.asarray, mj.init(jax.random.PRNGKey(0)))
    opt_j = jax_adamw.adamw_init(params_j, jax_adamw.AdamWConfig(**kw))
    want, got = [], []
    for i in range(5):
        batch = pipe.global_batch_arrays(i)
        params_t = tree_map(lambda t: t.requires_grad_(),
                            from_jax_params(cfg_t, jax.tree.map(np.asarray, params_j)))
        opt_t = {"step": int(opt_j["step"]), "m": from_jax_params(cfg_t, opt_j["m"]),
                 "v": from_jax_params(cfg_t, opt_j["v"])}
        params_j, opt_j, mj_ = step_j(params_j, opt_j,
                                      {k: jnp.asarray(v) for k, v in batch.items()})
        params_t, opt_t, mt_ = trainer.step(params_t, opt_t, batch)
        want.append((float(mj_["loss"]), float(mj_["grad_norm"])))
        got.append((float(mt_["loss"]), float(mt_["grad_norm"])))
        assert type(opt_t["step"]) is int and opt_t["step"] == int(opt_j["step"]) == i + 1
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1][0] < got[0][0]


def test_train_launcher_trains_the_hybrid_on_cpu(capsys):
    train_launcher.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
                         "--batch", "2", "--seq", "32", "--log-every", "1"])
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l.startswith("step ")]
    assert out.startswith(f"arch={ARCH}") and len(lines) == 3
    assert all(np.isfinite(float(l.split()[3])) for l in lines)
    assert "tokens/s" in out
