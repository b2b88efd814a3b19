"""Checkpointing with the reference's on-disk layout — the reference's
``repro.checkpoint.checkpoint``.

Layout: <dir>/step_<N>/
           manifest.json        — step, leaf count, the leaves' paths
           arrays.npz           — flat leaf arrays (host copies)

``leaf_i`` is the i-th leaf of the state in the reference's pytree order
(``models.params.tree_items``: dict keys sorted as strings at every
level); the trainer passes the parameters as the reference's tree
(stacked subtrees restacked to ``(layers, ...)``) and the optimizer
state keyed by the reference's leaf paths, so a checkpoint written by
either package restores in the other.  bfloat16, which npz cannot hold,
is written as float32 and cast back on restore.

  * writes go to a temp dir + rename — a failure mid-write never
    corrupts the latest checkpoint; ``keep`` newest steps are kept;
  * async save: the host copy is taken synchronously, the file write
    happens on a background thread so the train loop keeps stepping;
    ``wait`` joins it;
  * elastic restore: ``restore(like, shardings=)`` places each leaf
    under the matching ``NamedSharding`` of the mesh it is given — this
    rank's block on the mesh's device, as a ``DTensor`` — so a job
    restarted on another device count resumes from the same file (the
    file holds whole arrays).  ``save`` of ``DTensor`` leaves gathers
    each one (a collective: every rank of the mesh calls ``save``) and
    only the rank at mesh coordinate ``(0, ...)`` writes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from repro_torch.models.params import host_array, tree_items


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], list, bool]:
    """The leaves as host arrays, their paths, and whether this rank
    writes: a ``DTensor`` leaf is gathered whole on every rank of its
    mesh (``full_tensor``, a collective), and a rank off the mesh's
    coordinate ``(0, ...)`` keeps no copy and does not write."""
    arrays, paths, writes = {}, [], True
    for i, (path, x) in enumerate(tree_items(tree)):
        if isinstance(x, DTensor):
            writes &= not any(x.device_mesh.get_coordinate())
            x = x.full_tensor()
        if writes:
            arrays[f"leaf_{i}"] = host_array(x)
        paths.append(path)
    return arrays, paths, writes


def _unflatten(like, values: Iterator):
    return {k: (_unflatten(like[k], values) if isinstance(like[k], dict)
                else next(values)) for k in sorted(like)}


def _like(arr: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor of ``ref``'s dtype on its device (the
    CPU for a ``meta`` stand-in)."""
    dev = "cpu" if ref.device.type == "meta" else ref.device
    return torch.from_numpy(arr).to(device=dev, dtype=ref.dtype)


def _sharded(arr: np.ndarray, ref: torch.Tensor, shd) -> torch.Tensor:
    """This rank's block of a stored array under ``shd``, cast to
    ``ref``'s dtype, on the device of the mesh's type (the current CUDA
    device for a CUDA mesh), as a ``DTensor`` of the array's shape."""
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"stored leaf {arr.shape} vs {tuple(ref.shape)}")
    dev = torch.device(shd.mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return shd.distribute(torch.from_numpy(arr), dev, ref.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Dict[str, Any], blocking: bool = False):
        """state: a nested dict of tensors (``DTensor``s included),
        arrays or numbers."""
        arrays, paths, writes = _flatten(state)
        if not writes:
            return
        manifest = {"step": step, "treedef": "repro_torch leaves: "
                    + " ".join(paths), "n_leaves": len(arrays)}
        self.wait()
        t = threading.Thread(target=self._write, args=(step, arrays, manifest))
        t.start()
        self._thread = t
        if blocking:
            self.wait()

    def _write(self, step: int, arrays, manifest):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ----------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Dict[str, Any], step: Optional[int] = None,
                shardings=None) -> Tuple[int, Dict[str, Any]]:
        """Restore into the structure of ``like`` (a nested dict of
        tensors, ``meta`` stand-ins included): each leaf a tensor of
        ``like``'s leaf's dtype on its device.  ``shardings``: an
        optional matching nested dict of ``NamedSharding``s for the
        *current* mesh (elastic restore; e.g. from
        ``sharding.tree_shardings``): a leaf with one comes back as
        this rank's block on the mesh's device, a ``DTensor``.  Leaves
        are read one at a time, so a rank holds at most one whole leaf
        on the host."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        leaves_like = [x for _, x in tree_items(like)]
        sh_leaves = ([x for _, x in tree_items(shardings)]
                     if shardings is not None else [None] * len(leaves_like))
        assert len(sh_leaves) == len(leaves_like), \
            f"{len(sh_leaves)} shardings for {len(leaves_like)} leaves"
        with np.load(os.path.join(path, "arrays.npz")) as data:
            assert len(leaves_like) == len(data.files), \
                f"checkpoint has {len(data.files)} leaves, " \
                f"expected {len(leaves_like)}"
            out = [_like(data[f"leaf_{i}"], ref) if shd is None
                   else _sharded(data[f"leaf_{i}"], ref, shd)
                   for i, (ref, shd) in enumerate(zip(leaves_like,
                                                      sh_leaves))]
        return step, _unflatten(like, iter(out))
