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
    ``wait`` joins it.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import host_array, tree_items


def _flatten(tree) -> Tuple[Dict[str, np.ndarray], list]:
    arrays, paths = {}, []
    for i, (path, x) in enumerate(tree_items(tree)):
        arrays[f"leaf_{i}"] = host_array(x)
        paths.append(path)
    return arrays, paths


def _unflatten(like, values: Iterator):
    return {k: (_unflatten(like[k], values) if isinstance(like[k], dict)
                else next(values)) for k in sorted(like)}


def _like(arr: np.ndarray, ref: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor of ``ref``'s dtype on its device (the
    CPU for a ``meta`` stand-in)."""
    dev = "cpu" if ref.device.type == "meta" else ref.device
    return torch.from_numpy(arr).to(device=dev, dtype=ref.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Dict[str, Any], blocking: bool = False):
        """state: a nested dict of tensors, arrays or numbers."""
        arrays, paths = _flatten(state)
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

    def restore(self, like: Dict[str, Any], step: Optional[int] = None
                ) -> Tuple[int, Dict[str, Any]]:
        """Restore into the structure of ``like`` (a nested dict of
        tensors, ``meta`` stand-ins included): each leaf a tensor of
        ``like``'s leaf's dtype on its device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        leaves_like = [x for _, x in tree_items(like)]
        with np.load(os.path.join(path, "arrays.npz")) as data:
            assert len(leaves_like) == len(data.files), \
                f"checkpoint has {len(data.files)} leaves, " \
                f"expected {len(leaves_like)}"
            out = [_like(data[f"leaf_{i}"], ref)
                   for i, ref in enumerate(leaves_like)]
        return step, _unflatten(like, iter(out))
