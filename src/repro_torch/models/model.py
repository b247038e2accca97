"""Top-level model: embeddings + transformer stack(s) + LM head.

Counterpart of the JAX package's ``models/model.py`` for all of its
families: decoder-only dense and MoE configs, MLA (minicpm3),
attention-free SSM (Mamba-2) ones, hybrids of attention and SSM (jamba), a
decoder with a multimodal frontend (phi-3-vision) and an encoder-decoder
(seamless-m4t).  Parameters are a plain dict::

    {"embed": [V, D], "final_norm": [D], "lm_head": [D, V],
     ["frontend_proj": [D_frontend, D],] ["encoder": [ENC, ...],]
     "layers": [ {"ln1", "mixer": MIXER[, "ln_cross", "cross": GQA]
                  [, "ln2", "ffn": FFN]}, ... ]}

where MIXER is ``{"w_q", "w_k", "w_v", "w_o"[, "q_norm", "k_norm"]}`` (GQA)
on an attention layer, ``{"w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm",
"w_uk", "w_uv", "w_o"}`` where ``attn_type`` is "mla", and the SSM's dict
(``models/ssm.py``) elsewhere; FFN is ``{"w_gate", "w_up": [D, F],
"w_down": [F, D]}`` on a dense layer and ``{"router": [D, E], "w_gate",
"w_up": [E, D, F], "w_down": [E, F, D]}`` on an MoE layer
(``cfg.layer_is_moe``); a layer has no FFN where ``d_ff`` is 0.  An
encoder layer ENC is ``{"ln1", "mixer": GQA, "ln2", "ffn": dense FFN}``.

A frontend config takes precomputed frontend embeddings (the modality
encoder is a stub, as in the reference): with ``frontend_embeds`` [B, n,
D_frontend] in the batch, the first ``n`` positions are the projected rows
instead of token embeddings, and the loss masks them.  Without them the
model runs on text, as the engines serve it.  An encoder-decoder encodes
``encoder_frames`` [B, M, D_frontend] (projected, then the bidirectional
encoder, then ``final_norm``, as the reference does) and its decoder layers
attend to that memory through K/V computed once per prefill.

``init`` makes them in ``cfg.param_dtype`` (fp32) on the model's device.
``load`` casts the matrices to ``cfg.compute_dtype`` once; the JAX package
casts the fp32 weights on every call (``.astype(compute)``) and gets the
same values, so the served numbers do not change.  1-D leaves (norm scales,
biases, the SSM's ``a_log``/``dt_bias``/``d_skip``) stay in fp32: the
reference reads them in fp32, or casts them itself.  The engines load their
params this way.  ``train_loss`` takes the fp32 master params as ``init``
makes them and casts on every call, as the reference does, so that the
gradients reach the fp32 leaves.

The entry points take the reference's parameters in its order.  ``impl``
("xla" or "pallas") does not choose a path: the port takes its kernels on
the card and their plain versions on the CPU either way.  ``mesh`` must be
None (one device) and ``key`` is unused (no dropout).  A config the
reference could not build raises ``NotImplementedError``: a stack with SSM
layers and no SSM config, MLA layers with no MLA config, and an
encoder-decoder with no frontend to project its frames.
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..tree import tree_map
from . import transformer as tf
from .attention import cache_length
from .layers import cross_entropy_loss, dense_init, embed_init, rms_norm, zeros_init

__all__ = ["Model", "build_model"]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _one_device(impl: str, mesh) -> None:
    """The reference's ``impl`` and ``mesh``, in their places: both of its
    ``impl`` values name the port's one path; a mesh waits for the
    multi-device work (ROADMAP A11)."""
    if impl not in ("xla", "pallas"):
        raise NotImplementedError(f'impl must be "xla" or "pallas", got {impl!r}')
    if mesh is not None:
        raise NotImplementedError("the port's model runs on one device: mesh must be None")


def _tokens(batch) -> torch.Tensor:
    """The prompt tokens of ``batch``: the reference's ``{"tokens": [B, S]}``,
    or the [B, S] tokens themselves."""
    return batch["tokens"] if isinstance(batch, dict) else batch


class Model:
    """Entry points of the model: ``init``, ``load``, ``train_loss``,
    ``init_cache``, ``prefill``, ``mask_prompt_cache``,
    ``prepare_decode_caches`` and ``decode_step``.  Runs on ``device``
    (``cuda`` unless asked otherwise)."""

    def __init__(self, cfg: ModelConfig, device: str | torch.device | None = None):
        # a layer that is not attention is an SSM layer, whose parameters
        # come from cfg.ssm (src/repro/models/transformer.py:58-70); MLA
        # layers take theirs from cfg.mla, and the encoder's frames go
        # through frontend_proj (src/repro/models/model.py:29-33, :88-93)
        ssm_layers = any(not cfg.layer_is_attention(i) for i in range(cfg.n_layers))
        unsupported = [
            name for name, on in (
                ("a stack with SSM layers without an SSM config", ssm_layers and cfg.ssm is None),
                ("MLA layers without an MLA config", cfg.attn_type == "mla" and cfg.mla is None),
                ("an encoder-decoder without a frontend", cfg.enc_dec and cfg.frontend is None),
            ) if on
        ]
        if unsupported:
            raise NotImplementedError(
                f"{cfg.name}: the port does not run {', '.join(unsupported)}, which the "
                "reference cannot build either"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.compute_dtype = _dtype(cfg.compute_dtype)

    # ---------------- parameters ----------------
    def init(self, gen: torch.Generator) -> dict:
        """Fresh parameters in ``param_dtype`` on ``gen``'s device, which
        must be the model's device."""
        if torch.device(gen.device).type != self.device.type:
            raise ValueError(f"generator on {gen.device}, model on {self.device}")
        cfg = self.cfg
        dtype = _dtype(cfg.param_dtype)
        params = {
            "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
            "final_norm": zeros_init(gen, (cfg.d_model,), dtype),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab), dtype)
        if cfg.frontend is not None:
            params["frontend_proj"] = dense_init(gen, (cfg.frontend.d_frontend, cfg.d_model),
                                                 dtype)
        if cfg.enc_dec:
            params["encoder"] = [tf.encoder_block_init(gen, cfg, dtype)
                                 for _ in range(cfg.n_encoder_layers)]
        params["layers"] = tf.stack_init(gen, cfg, dtype)
        return params

    def load(self, params: dict) -> dict:
        """Params on the model's device, matrices in the compute dtype -- the
        one cast of the weights -- and 1-D leaves in fp32.  Tensors already in
        place are returned as they are."""
        return tree_map(lambda t: t.to(device=self.device, dtype=self.compute_dtype if t.dim() > 1
                                   else torch.float32), params)

    def decay_mask(self, params: dict) -> dict:
        """A bool per leaf of ``params``: whether AdamW decays it, as the
        reference's ``_decay_mask`` (``ndim >= 2``) decides on its own tree.
        There every layer leaf is stacked over the repeats of the layer
        pattern when the pattern repeats, so a per-layer 1-D leaf (a norm
        scale, a bias, the SSM's ``a_log``, ``dt_bias``, ``d_skip``) has two
        dims there and is decayed; outside the layers only matrices are.  The
        encoder's layers stack when there are more than one (its period is
        1)."""
        cfg = self.cfg
        stacked = {"layers": cfg.n_layers // cfg.pattern_period() > 1,
                   "encoder": cfg.n_encoder_layers > 1}
        return {k: tree_map(lambda t, extra=stacked.get(k, False): t.dim() + extra >= 2, v)
                for k, v in params.items()}

    # ---------------- caches ----------------
    def init_cache(self, batch: int, seq_len: int, mem_len: int = 0) -> dict:
        """Empty decode caches of ``seq_len`` ring entries; an
        encoder-decoder's cross K/V of ``mem_len`` rows."""
        return tf.init_stack_cache(self.cfg, batch, seq_len, self.compute_dtype, self.device,
                                   mem_len)

    # ---------------- shared pieces ----------------
    def _batch(self, batch: dict, name: str) -> torch.Tensor:
        return torch.as_tensor(batch[name], device=self.device)

    def _embed_inputs(self, params: dict, batch, gather_first: bool = False):
        """(x [B, S, D] in the compute dtype, loss mask [B, S] fp32): the
        token embeddings, the first ``n`` replaced by the projected
        ``frontend_embeds`` [B, n, D_frontend] where a decoder-only config
        has a frontend and the batch carries them (and masked out of the
        loss).
        ``gather_first`` gathers the fp32 rows and casts them (training),
        the values of the reference's cast-then-gather."""
        cfg, cd = self.cfg, self.compute_dtype
        tokens = torch.as_tensor(_tokens(batch), device=self.device).long()
        if gather_first:
            x = params["embed"][tokens].to(cd)
        else:
            x = params["embed"].to(cd)[tokens]
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=self.device)
        if (cfg.frontend is not None and not cfg.enc_dec and isinstance(batch, dict)
                and "frontend_embeds" in batch):
            fe = self._batch(batch, "frontend_embeds").to(cd) @ params["frontend_proj"].to(cd)
            n = fe.shape[1]
            x = torch.cat([fe, x[:, n:]], dim=1)
            mask[:, :n] = 0.0
        return x, mask

    def _encode(self, params: dict, batch: dict) -> torch.Tensor:
        """The encoder's memory [B, M, D]: the projected ``encoder_frames``
        through the bidirectional stack, normed with ``final_norm`` (the
        reference's choice)."""
        cd = self.compute_dtype
        x = self._batch(batch, "encoder_frames").to(cd) @ params["frontend_proj"].to(cd)
        x = tf.encoder_apply(params["encoder"], x, self.cfg)
        return rms_norm(x, params["final_norm"], self.cfg.norm_eps)

    def _decoder_cross_caches(self, params: dict, memory: torch.Tensor) -> dict:
        """Every decoder layer's cross-attention K/V of ``memory``, stacked:
        ``{"cross_k", "cross_v": [n_layers, B, M, KV, D]}``."""
        kv = [tf.cross_kv(layer["cross"], memory, self.cfg) for layer in params["layers"]]
        return {"cross_k": torch.stack([k for k, _ in kv]),
                "cross_v": torch.stack([v for _, v in kv])}

    def _decoder(self, params: dict, batch, gather_first: bool = False, **kw):
        """(x, caches, aux, loss mask) of the decoder stack over ``batch``:
        for an encoder-decoder against its encoded ``encoder_frames``."""
        cross = None
        if self.cfg.enc_dec:
            cross = self._decoder_cross_caches(params, self._encode(params, batch))
        x, mask = self._embed_inputs(params, batch, gather_first)
        b, s, _ = x.shape
        positions = torch.arange(s, device=self.device).expand(b, s)
        x, caches, aux = tf.stack_apply(params["layers"], x, self.cfg, positions=positions,
                                        cross=cross, **kw)
        return x, caches, aux, mask

    # ---------------- training ----------------
    def train_loss(self, params: dict, batch: dict, key=None, impl: str = "xla", mesh=None):
        """Mean next-token cross entropy of ``batch`` (``tokens`` and
        ``targets`` [B, S], an optional ``mask`` [B, S]; tensors or numpy
        arrays) under the fp32 master ``params``; returns (loss,
        {"loss", "aux_loss"}).  ``aux_loss`` is the MoE layers'
        load-balancing loss summed over the layers (0 without them); for an
        MoE config the returned loss adds ``0.01 * aux_loss`` to the cross
        entropy, which ``metrics["loss"]`` holds alone, as in the reference.
        A frontend config's batch may carry ``frontend_embeds`` (their
        positions weigh 0 in the loss); an encoder-decoder's carries
        ``encoder_frames``."""
        _one_device(impl, mesh)
        cfg = self.cfg
        # rows gathered, then cast: the values of the reference's cast-then-gather
        x, _, aux, mask = self._decoder(params, batch, gather_first=True)
        logits = self._logits(params, x)
        if "mask" in batch:
            mask = mask * self._batch(batch, "mask")
        loss = cross_entropy_loss(logits, self._batch(batch, "targets"), mask)
        metrics = {"loss": loss, "aux_loss": aux}
        if cfg.moe is not None:
            loss = loss + 0.01 * aux
        return loss, metrics

    # ---------------- serving ----------------
    def _logits(self, params, x):
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        head = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        return x @ head.to(x.dtype)

    def prefill(self, params: dict, batch, impl: str = "xla", mesh=None, last_pos=None):
        """Forward over the prompt ``batch`` (``{"tokens": [B, S]}`` as the
        reference takes it, with ``frontend_embeds`` or ``encoder_frames``
        where the config takes them, or the tokens themselves); returns
        (logits [B, 1, V] at ``last_pos`` (default: the last position),
        caches).  ``last_pos`` [B] selects the last real token of
        right-padded prompts; pair it with :meth:`mask_prompt_cache`."""
        _one_device(impl, mesh)
        x, caches, _, _ = self._decoder(params, batch, update_cache=True)
        b = x.shape[0]
        if last_pos is None:
            x_last = x[:, -1:]
        else:
            idx = torch.as_tensor(last_pos, device=self.device).long().reshape(-1)
            x_last = x[torch.arange(b, device=self.device), idx][:, None]
        return self._logits(params, x_last), caches

    def mask_prompt_cache(self, caches: dict, true_len) -> dict:
        """Invalidate the attention entries written by right-pad positions
        >= ``true_len`` (scalar or [B]) so that decode never attends to
        padding.  SSM state has no positional record and passes through: an
        SSM prompt must be prefilled at its exact length (the engines do)."""
        if "pos" not in caches:
            return caches
        true_len = torch.as_tensor(true_len, device=self.device, dtype=torch.int32)
        bound = true_len[:, None] if true_len.dim() == 1 else true_len
        pos = caches["pos"]  # [n_layers, B, S]
        return {**caches, "pos": torch.where(pos < bound, pos, torch.full_like(pos, -1))}

    def prepare_decode_caches(self, caches: dict, capacity: int) -> dict:
        """Re-lay prefill caches into decode ring buffers with headroom:
        entry at slot ``pos % cap`` with ``cap = capacity`` (SWA layers:
        ``min(capacity, window)`` most recent entries).  Dropped entries go
        to a discard slot ``cap`` that is cut off at the end.  SSM caches
        (O(1) state) and an encoder-decoder's cross K/V pass through."""
        if "pos" not in caches:
            return caches
        names = ("k", "v") if "k" in caches else ("ckv", "k_rope")
        cap = cache_length(self.cfg, capacity)
        pos = caches["pos"]  # [n_layers, B, L]
        max_pos = pos.max(dim=-1, keepdim=True).values
        keep = (pos >= 0) & (pos > max_pos - cap)
        slot = torch.where(keep, pos % cap, torch.full_like(pos, cap)).long()

        def scatter(src, fill):
            shape = src.shape[:2] + (cap + 1,) + src.shape[3:]
            dst = torch.full(shape, fill, dtype=src.dtype, device=src.device)
            idx = slot.reshape(slot.shape + (1,) * (src.dim() - 3)).expand(src.shape)
            return dst.scatter_(2, idx, src)[:, :, :cap]

        return {
            **caches,
            **{n: scatter(caches[n], 0) for n in names},
            "pos": scatter(torch.where(keep, pos, torch.full_like(pos, -1)), -1),
        }

    def decode_step(self, params: dict, caches: dict, tokens: torch.Tensor, pos: torch.Tensor,
                    impl: str = "xla", mesh=None, ragged: bool = False):
        """One token per row: ``tokens`` [B, 1], ``pos`` [B] absolute
        positions.  ``ragged=False`` advances the batch in lockstep (one
        shared ring slot); ``ragged=True`` writes each row's own slot
        (continuous batching).  Writes into ``caches`` in place; returns
        (logits [B, 1, V], caches)."""
        _one_device(impl, mesh)
        tokens = tokens.to(self.device)
        x = params["embed"].to(self.compute_dtype)[tokens]
        positions = pos.to(self.device)[:, None]
        x, caches, _ = tf.stack_apply(params["layers"], x, self.cfg, positions=positions,
                                      caches=caches, ragged=ragged)
        return self._logits(params, x), caches


def build_model(cfg: ModelConfig, device: str | torch.device | None = None) -> Model:
    return Model(cfg, device)
