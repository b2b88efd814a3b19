"""Unified Model API: one ``nn.Module`` serving every LM architecture of
the configs — the reference's ``repro.models.model``.

  * ``forward(batch)``                 -> (logits, aux, load, hidden)
  * ``loss(batch)``                    -> (loss, metrics), MTP and aux in
  * ``prefill(batch, cache)``          -> last-token logits, filled cache
  * ``decode_step(cache, tokens, i)``  -> logits of one token a sequence

plus spec trees (params, cache, and ``input_specs`` for the inputs) so the
dry run never allocates the full-size configs: ``Model(cfg,
device="meta")`` holds shapes only.

The module holds its parameters as a ``ParamTree`` of its spec tree
(the reference's tree, the stacked ``blocks`` as a ``ModuleList``), so
``state_dict`` keys are the reference's paths joined by dots, a block's
index after ``blocks``.  ``Model(cfg, device=...)`` allocates them;
``init_params`` draws them on a CPU generator seeded from ``seed`` and
copies them to the device, so a card and a CPU model made from one seed
start from the same weights; ``lm_params_from_numpy`` carries the
reference's own parameters across.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import params as P
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.layers import embed, embedding_spec, softcap, unembed
from repro_torch.models.params import Spec, lm_params_from_numpy  # noqa: F401
from repro_torch.parallel.sharding import constrain

ENC_LEN_FOR_DECODE = 1504  # whisper: 30 s of audio -> ~1500 frames (padded)


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy in fp32; targets < 0 are ignored."""
    logits = logits.float()
    valid = targets >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    t = torch.clamp_min(targets, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    # the gathered logit settled before the select: on vocab-sharded
    # DTensor logits it is partial over the vocab's axis, masked by the
    # gather's shape
    gold = constrain(torch.gather(logits, -1, t[..., None]),
                     "batch", "seq", None)[..., 0]
    nll = (lse - gold) * valid
    return torch.sum(nll) / torch.clamp_min(torch.sum(valid), 1)


def param_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's parameter spec tree of ``cfg``, leaf for leaf."""
    spec: Dict[str, Any] = {"embed": embedding_spec(cfg.vocab, cfg.d_model)}
    spec["decoder"] = T.decoder_spec(cfg, cross=cfg.is_encdec)
    spec["final_norm"] = T._norm_spec(cfg)
    if cfg.is_encdec:
        spec["encoder"] = T.encoder_spec(cfg)
    if cfg.vision_stub:
        spec["vision_proj"] = {
            "w": Spec((cfg.d_model, cfg.d_model), ("embed", None))}
    if not cfg.tie_embeddings:
        spec["lm_head"] = {
            "w": Spec((cfg.d_model, cfg.vocab), ("embed", "vocab"))}
    if cfg.mtp:
        spec["mtp"] = {
            "proj": {"w": Spec((2 * cfg.d_model, cfg.d_model),
                               ("embed", None))},
            "block": T.block_spec(cfg, *_mtp_kinds(cfg)),
            "norm": T._norm_spec(cfg),
        }
    return spec


def cache_spec(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0):
    """The reference's decode cache spec tree of ``cfg``."""
    cross_len = enc_len if cfg.is_encdec else 0
    return T.decoder_cache_spec(cfg, batch, max_len, cross_len)


def _mtp_kinds(cfg: ModelConfig) -> Tuple[str, str]:
    return ("mla" if cfg.use_mla else "global",
            "dense_first" if cfg.dense_d_ff else "dense")


class Model(P.ParamTree):
    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__(param_spec(cfg), cfg.param_dtype,
                         resolve_device(device))
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self["final_norm"]["scale"].device

    # ------------------------------------------------------------------ specs
    def param_spec(self) -> Dict[str, Any]:
        return param_spec(self.cfg)

    def init_params(self, seed: int = 0,
                    generator: Optional[torch.Generator] = None) -> "Model":
        """Draw every parameter by its spec's rule from ``generator``
        (default: a CPU generator seeded with ``seed``, whatever the
        model's device) and copy it onto the model's device."""
        if generator is None:
            generator = torch.Generator().manual_seed(seed)
        return self.init_from(generator, self.cfg.param_dtype)

    def cache_spec(self, batch: int, max_len: int, enc_len: int = 0):
        return cache_spec(self.cfg, batch, max_len, enc_len)

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0):
        """An empty cache on the model's device: zeros, and ``pos`` = -1
        (empty attention slots are masked out).  The stacked blocks'
        entries are a list, one dict a block."""
        dev, cd = self.device, self.cfg.compute_dtype

        def build(tree):
            out = {}
            for k, s in tree.items():
                if P.is_spec(s):
                    out[k] = torch.full(s.shape, -1 if k == "pos" else 0,
                                        dtype=P.torch_dtype(s.dtype or cd),
                                        device=dev)
                elif P.is_stacked(s):
                    n, layer = P.unstack(s)
                    out[k] = [build(layer) for _ in range(n)]
                else:
                    out[k] = build(s)
            return out
        return build(self.cache_spec(batch, max_len, enc_len))

    # -------------------------------------------------------------- embedding
    def _compute_dtype(self) -> torch.dtype:
        return P.torch_dtype(self.cfg.compute_dtype)

    def _scale_embed(self, x):
        if self.cfg.scale_embed:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _embed_inputs(self, batch, compute_dtype):
        cfg = self.cfg
        with ssm.embedding_layout(cfg):
            x = self._scale_embed(embed(self["embed"], batch["tokens"],
                                        compute_dtype))
        if cfg.vision_stub and "vision_embed" in batch:
            v = torch.matmul(batch["vision_embed"].to(compute_dtype),
                             self["vision_proj"]["w"].to(compute_dtype))
            m = batch["vision_mask"][..., None].to(compute_dtype)
            x = x * (1 - m) + v * m
        if cfg.pos_embed == "sinusoidal":
            x = x + T.sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                           x.device)[None]
        return constrain(x, "batch", "seq", "d_model")

    def _positions(self, batch, seq: int):
        cfg = self.cfg
        if cfg.mrope_sections != (0, 0, 0) and "mrope_pos" in batch:
            return batch["mrope_pos"]
        b = batch["tokens"].shape[0]
        return torch.arange(seq, dtype=torch.int32,
                            device=self.device)[None].expand(b, seq)

    def _encode(self, batch, train, compute_dtype):
        cfg = self.cfg
        ae = batch["audio_embed"].to(compute_dtype)
        s = ae.shape[1]
        enc_in = ae + T.sinusoidal_positions(s, cfg.d_model, ae.dtype,
                                             ae.device)[None]
        pos = torch.arange(s, dtype=torch.int32,
                           device=ae.device)[None].expand(ae.shape[0], s)
        return T.apply_encoder(cfg, self["encoder"], enc_in, pos,
                               train=train, compute_dtype=compute_dtype)

    def _lm_logits(self, x, compute_dtype):
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = unembed(self["embed"], x, compute_dtype)
        else:
            logits = torch.matmul(x, self["lm_head"]["w"].to(compute_dtype))
            logits = constrain(logits, "batch", "seq", "vocab")
        return softcap(logits, cfg.final_softcap)

    # ------------------------------------------------------------------ train
    def forward(self, batch, train: bool = True):
        """Full-sequence forward -> (logits, aux, load, final hidden)."""
        cfg = self.cfg
        cd = self._compute_dtype()
        x = self._embed_inputs(batch, cd)
        positions = self._positions(batch, x.shape[1])
        enc_out = self._encode(batch, train, cd) if cfg.is_encdec else None
        x, _, (aux, load) = T.apply_decoder(
            cfg, self["decoder"], x, positions=positions, enc_out=enc_out,
            train=train, compute_dtype=cd)
        x = T._norm(cfg, self["final_norm"], x)
        return self._lm_logits(x, cd), aux, load, x

    def loss(self, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        logits, aux, load, h_final = self.forward(batch, train=True)
        loss = softmax_xent(logits, batch["targets"])
        metrics = {"xent": loss, "aux": aux, "expert_load": load}
        if cfg.mtp:
            loss_mtp = self._mtp_loss(batch, h_final)
            metrics["mtp"] = loss_mtp
            loss = loss + 0.3 * loss_mtp
        loss = loss + aux
        metrics["loss"] = loss
        return loss, metrics

    def _mtp_loss(self, batch, h_final):
        """DeepSeek-V3 multi-token prediction: predict t+2 from
        [h_t ; emb(token_{t+1})] through one extra block."""
        cfg = self.cfg
        cd = self._compute_dtype()
        targets = batch["targets"]                        # token at t+1
        emb_next = embed(self["embed"], torch.clamp_min(targets, 0), cd)
        h = torch.cat([h_final, emb_next], dim=-1)
        h = torch.matmul(h, self["mtp"]["proj"]["w"].to(cd))
        positions = self._positions(batch, h.shape[1])
        h, _, _ = T.apply_block(cfg, *_mtp_kinds(cfg), self["mtp"]["block"],
                                h, positions=positions, compute_dtype=cd)
        h = T._norm(cfg, self["mtp"]["norm"], h)
        logits = self._lm_logits(h, cd)
        # target at t+2 == targets shifted left by one; last position invalid
        t2 = torch.cat([targets[:, 1:], torch.full_like(targets[:, :1], -1)],
                       dim=1)
        return softmax_xent(logits, t2)

    # ---------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, batch, cache):
        """Process the prompt, fill the cache, return last-token logits."""
        cfg = self.cfg
        cd = self._compute_dtype()
        x = self._embed_inputs(batch, cd)
        positions = self._positions(batch, x.shape[1])
        enc_out = self._encode(batch, False, cd) if cfg.is_encdec else None
        x, new_cache, _ = T.apply_decoder(
            cfg, self["decoder"], x, positions=positions, cache=cache,
            cache_index=0, enc_out=enc_out, train=False, compute_dtype=cd)
        x = T._norm(cfg, self["final_norm"], x[:, -1:])
        return self._lm_logits(x, cd), new_cache

    @torch.no_grad()
    def decode_step(self, cache, tokens: torch.Tensor, index: int):
        """One token for every sequence in the batch.

        tokens: (B, 1) int; index: the current position (a Python int).
        The cache's attention entries are written in place."""
        cfg = self.cfg
        cd = self._compute_dtype()
        index = int(index)
        x = self._scale_embed(embed(self["embed"], tokens, cd))
        if cfg.pos_embed == "sinusoidal":
            x = x + T.sinusoidal_at(index, cfg.d_model, x.dtype,
                                    x.device)[None, None, :]
        b = tokens.shape[0]
        shape = (3, b, 1) if cfg.mrope_sections != (0, 0, 0) else (b, 1)
        pos = torch.full(shape, index, dtype=torch.int32, device=x.device)
        x, new_cache, _ = T.apply_decoder(
            cfg, self["decoder"], x, positions=pos, cache=cache,
            cache_index=index, train=False, compute_dtype=cd)
        x = T._norm(cfg, self["final_norm"], x)
        return self._lm_logits(x, cd), new_cache


# ---------------------------------------------------------------------------
# Input specs per (arch x shape) — meta tensors + logical axes
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    """Returns (dict of tensors on the ``meta`` device, dict of
    logical-axes tuples) — the reference's ShapeDtypeStruct tree."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    cd = P.torch_dtype(cfg.compute_dtype)
    specs: Dict[str, Any] = {}
    axes: Dict[str, Any] = {}

    def add(name, shp, ax, dtype=i32):
        specs[name] = torch.empty(shp, dtype=dtype, device="meta")
        axes[name] = ax

    if shape.kind in ("train", "prefill"):
        add("tokens", (b, s), ("batch", "seq"))
        if shape.kind == "train":
            add("targets", (b, s), ("batch", "seq"))
        if cfg.is_encdec:
            add("audio_embed", (b, s, cfg.d_model),
                ("batch", "seq", "d_model"), cd)
        if cfg.vision_stub:
            add("vision_embed", (b, s, cfg.d_model),
                ("batch", "seq", "d_model"), cd)
            add("vision_mask", (b, s), ("batch", "seq"))
            add("mrope_pos", (3, b, s), (None, "batch", "seq"))
    else:  # decode
        add("tokens", (b, 1), ("batch", None))
        if cfg.vision_stub:
            add("mrope_pos", (3, b, 1), (None, "batch", None))
    return specs, axes
