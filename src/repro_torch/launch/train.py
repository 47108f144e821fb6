"""Training launcher (the port of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --steps 30

trains on the card ("cuda"; `--device cpu` runs here); without `--reduced`
it trains the published config at `--shape` (`train_4k` by default).
Checkpoints land in `--ckpt-dir`, and a rerun with the same directory
resumes from the latest one. The port has its sharding rules
(`parallel.sharding`, `Trainer(rules=, shardings=)`), but multi-card
execution of them (`--coordinator`: `torch.distributed` over an explicit
`tcp://` address) is ROADMAP item 23.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from ..configs import SHAPES_BY_NAME, get_config, list_archs, reduced
from ..configs.base import ShapeConfig


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES_BY_NAME))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config + tiny shape (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of a multi-host run (not in the port "
                         "yet: ROADMAP item 23)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    if args.coordinator:
        raise NotImplementedError(
            "multi-host training (--coordinator) is ROADMAP item 23, the "
            "multi-card part of ROADMAP item 8: the sharding rules run on "
            "one device or on abstract meshes only")

    from ..optim import adamw
    from ..train.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
        shape = ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")
    else:
        shape = SHAPES_BY_NAME[args.shape or "train_4k"]

    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, shape, tcfg=tcfg,
                      opt_cfg=adamw.AdamWConfig(lr=args.lr,
                                                total_steps=args.steps),
                      device=args.device)
    out = trainer.run()
    print(f"done: step {out['final_step']}, loss {out['losses'][-1]:.4f}, "
          f"stragglers {out['straggler_steps']}")
    return out


if __name__ == "__main__":
    main()
