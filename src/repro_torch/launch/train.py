"""Training launcher of the port — the reference's
``repro.launch.train``: the Trainer on ``make_host_mesh(data=<the world
size>)``.

  python -m repro_torch.launch.train --arch granite-3-2b --steps 20 \\
      --device cuda
  python -m repro_torch.launch.train --arch gemma2-2b --full \\
      --steps 3 --batch 2 --seq 1024          # on the card

``--smoke`` (the default) selects the reduced config; ``--full`` the
full config, which must fit one device (parameters are replicated: a
config that does not fit fails with the device's own out-of-memory
error).  ``--device`` defaults to the card.  Run alone, the world is
this process (a world of one, started and ended here); started in a
process group of N ranks (one process a device), it trains data-parallel
over them."""
from __future__ import annotations

import argparse
import os
import tempfile

import torch.distributed as dist

from repro_torch.common.config import TrainConfig
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import Model
from repro_torch.train.loop import Trainer, lm_batch_iterator


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ALL_ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", default="none",
                    choices=("none", "bf16"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tc = TrainConfig(steps=args.steps, learning_rate=args.lr,
                     microbatches=args.microbatches,
                     checkpoint_dir=args.ckpt_dir,
                     checkpoint_every=args.ckpt_every,
                     pod_grad_compression=args.compression)
    owns_world = not dist.is_initialized()
    mesh = make_host_mesh(
        data=dist.get_world_size() if dist.is_initialized() else 1,
        device=dev)
    try:
        model = Model(cfg, device=dev)
        trainer = Trainer(model, tc, mesh=mesh)
        res = trainer.run(lm_batch_iterator(cfg, args.batch, args.seq))
    finally:
        if owns_world and dist.is_initialized():
            dist.destroy_process_group()
    print(f"[train] done: {res.steps_run} steps, "
          f"loss {res.losses[0]:.4f} -> {res.final_loss:.4f}, "
          f"{res.wall_s:.1f}s"
          + (f" (resumed from {res.resumed_from})" if res.resumed_from
             else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
