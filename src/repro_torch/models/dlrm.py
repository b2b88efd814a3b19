"""DLRM — the paper's own §8 workload: deep learning recommendation
model (bottom MLP over dense features, embedding tables for sparse
features, pairwise dot interaction, top MLP), scored and trained on the
batches the BALBOA ingest lands on the card.  Training is torch autograd
on these products, as the reference leaves them to ``jax.grad``.

The parameters keep the reference's layout (``repro.models.dlrm``):
weights are ``(in, out)`` and a layer computes ``x @ w + b``; the 26
embedding tables are one ``(n_sparse, embed_rows, embed_dim)`` tensor so
that the lookup is a single gather.  ``dlrm_params_from_numpy`` carries
the reference's parameter tree across; without it the module
initialises itself from a CPU ``torch.Generator`` seeded with ``seed``
(the same weights on every device) with the reference's scheme (tables
``0.02 * N(0, 1)``, weights ``N(0, 1) / sqrt(fan_in)``, biases zero) —
the reference's distributions, not its numbers.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.common.config import DLRMConfig
from repro_torch.device import DeviceLike, resolve_device, to_device


def _layer_dims(cfg: DLRMConfig) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    n_f = cfg.n_sparse + 1
    inter_dim = cfg.bottom_mlp[-1] + n_f * (n_f - 1) // 2
    return (cfg.n_dense,) + tuple(cfg.bottom_mlp), \
        (inter_dim,) + tuple(cfg.top_mlp)


class DLRM(nn.Module):
    def __init__(self, cfg: DLRMConfig, *, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        if cfg.param_dtype != "float32" or cfg.compute_dtype != "float32":
            raise NotImplementedError("the port's DLRM runs in float32 only")
        self.cfg = cfg
        dev = resolve_device(device)
        # drawn on the host whatever the device: a card model and a CPU
        # model made from one seed start from the same weights
        gen = torch.Generator().manual_seed(seed)

        def normal(shape, std):
            return nn.Parameter((std * torch.randn(
                shape, generator=gen, dtype=torch.float32)).to(dev))

        def mlp(dims):
            w = nn.ParameterList(
                [normal((dims[i], dims[i + 1]), 1.0 / math.sqrt(dims[i]))
                 for i in range(len(dims) - 1)])
            b = nn.ParameterList(
                [nn.Parameter(torch.zeros(dims[i + 1], device=dev))
                 for i in range(len(dims) - 1)])
            return w, b

        self.tables = normal((cfg.n_sparse, cfg.embed_rows, cfg.embed_dim),
                             0.02)
        bottom, top = _layer_dims(cfg)
        self.bottom_w, self.bottom_b = mlp(bottom)
        self.top_w, self.top_b = mlp(top)
        n_f = cfg.n_sparse + 1
        self.register_buffer("_iu", torch.triu_indices(n_f, n_f, 1,
                                                       device=dev),
                             persistent=False)
        self.register_buffer("_cols", torch.arange(cfg.n_sparse,
                                                   device=dev),
                             persistent=False)

    def forward(self, dense: torch.Tensor, sparse: torch.Tensor
                ) -> torch.Tensor:
        """dense (B, n_dense) float32 (already preprocessed on the
        datapath), sparse (B, n_sparse) int32 ids -> (B,) logits.

        Ids outside ``[0, embed_rows)`` are taken as the reference's
        gather takes them: a negative id counts from the end, then the
        id is clamped into the table (torch's indexing would raise).  The
        reference's gradient of that gather is a scatter that DROPS an
        id still out of range after the wrap, so such an id reads the
        clamped row but sends it no gradient."""
        rows = self.cfg.embed_rows
        x = dense
        for w, b in zip(self.bottom_w, self.bottom_b):
            x = torch.relu(x @ w + b)
        idx = sparse.to(torch.int64)
        idx = torch.where(idx < 0, idx + rows, idx)
        valid = (idx >= 0) & (idx < rows)
        embs = self.tables[self._cols[None, :], idx.clamp(0, rows - 1)]
        if embs.requires_grad:                                # (B, S, D)
            embs = torch.where(valid[..., None], embs, embs.detach())
        feats = torch.cat([x[:, None, :], embs], dim=1)       # (B, F, D)
        inter = torch.bmm(feats, feats.transpose(1, 2))       # (B, F, F)
        z = torch.cat([x, inter[:, self._iu[0], self._iu[1]]], dim=1)
        n_top = len(self.top_w)
        for i, (w, b) in enumerate(zip(self.top_w, self.top_b)):
            z = z @ w + b
            if i < n_top - 1:
                z = torch.relu(z)
        return z[:, 0]

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean binary cross-entropy on logits (the reference's stable
        form) and accuracy, for a batch with ``dense``, ``sparse`` and
        ``label``."""
        logits = self(batch["dense"], batch["sparse"])
        y = batch["label"]
        nll = torch.mean(torch.clamp_min(logits, 0) - logits * y
                         + torch.log1p(torch.exp(-torch.abs(logits))))
        acc = torch.mean(((logits > 0) == (y > 0.5)).to(torch.float32))
        return nll, {"loss": nll, "acc": acc}


def dlrm_params_from_numpy(tree: Dict, device: DeviceLike = None
                           ) -> Dict[str, torch.Tensor]:
    """The reference DLRM's parameter tree (``{"tables": {"t0": ...},
    "bottom": {"l0": {"w", "b"}}, "top": ...}`` as numpy arrays) as a
    state dict for ``DLRM.load_state_dict``, on ``device`` (default the
    card)."""
    dev = resolve_device(device)
    n_sparse = len(tree["tables"])
    out = {"tables": to_device(np.stack(
        [np.asarray(tree["tables"][f"t{i}"], np.float32)
         for i in range(n_sparse)]), dev)}
    for part in ("bottom", "top"):
        for i in range(len(tree[part])):
            layer = tree[part][f"l{i}"]
            out[f"{part}_w.{i}"] = to_device(
                np.asarray(layer["w"], np.float32), dev)
            out[f"{part}_b.{i}"] = to_device(
                np.asarray(layer["b"], np.float32), dev)
    return out


def _ravel_leaves(model: DLRM, grad: bool):
    """The model's parameters (or their ``.grad``) in the order
    ``jax.flatten_util.ravel_pytree`` walks the reference's tree: dict
    keys sorted as strings (``bottom`` < ``tables`` < ``top``; ``b`` <
    ``w`` inside a layer; ``l10`` < ``l2``; ``t10`` < ``t2``), each leaf
    row-major.  The 26 tables are one tensor here, so they come out
    through one gather in that order."""
    def get(p):
        return p.grad if grad else p

    def mlp(ws, bs):
        out = []
        for i in sorted(range(len(ws)), key=lambda i: f"l{i}"):
            out += [get(bs[i]), get(ws[i])]
        return out

    n_sparse = model.tables.shape[0]
    perm = sorted(range(n_sparse), key=lambda i: f"t{i}")
    tables = get(model.tables)[torch.tensor(perm,
                                            device=model.tables.device)]
    return (mlp(model.bottom_w, model.bottom_b) + [tables]
            + mlp(model.top_w, model.top_b))


def ravel_params(model: DLRM, *, grad: bool = False) -> torch.Tensor:
    """The model's parameters as one flat float32 vector on its device,
    element for element the vector ``ravel_pytree`` makes of the
    reference's parameter tree (so a flat gradient of either package is
    the same vector, and ring chunk boundaries agree).  ``grad=True``
    ravels the parameters' gradients instead.  A copy, outside autograd."""
    with torch.no_grad():
        return torch.cat([t.reshape(-1)
                          for t in _ravel_leaves(model, grad)])


def unravel_params(model: DLRM, flat: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """Inverse of ``ravel_params``: a flat vector in ``ravel_pytree``'s
    order -> a state dict of the model's parameter names (the shape
    ``dlrm_params_from_numpy`` returns), on ``flat``'s device."""
    named = dict(model.named_parameters())
    n_sparse = model.tables.shape[0]
    perm = sorted(range(n_sparse), key=lambda i: f"t{i}")

    def mlp_names(part, n):
        out = []
        for i in sorted(range(n), key=lambda i: f"l{i}"):
            out += [f"{part}_b.{i}", f"{part}_w.{i}"]
        return out

    names = (mlp_names("bottom", len(model.bottom_w)) + ["tables"]
             + mlp_names("top", len(model.top_w)))
    sizes = [named[n].numel() for n in names]
    if flat.numel() != sum(sizes):
        raise ValueError(f"flat vector has {flat.numel()} elements, the "
                         f"model {sum(sizes)}")
    out = {}
    for name, piece in zip(names, torch.split(flat, sizes)):
        out[name] = piece.reshape(named[name].shape)
    inv = torch.empty(n_sparse, dtype=torch.int64)
    inv[torch.tensor(perm)] = torch.arange(n_sparse)
    out["tables"] = out["tables"][inv.to(flat.device)]
    return out
