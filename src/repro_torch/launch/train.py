"""Training launcher (the port of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --steps 30

trains on the card ("cuda"; `--device cpu` runs here); without `--reduced`
it trains the published config at `--shape` (`train_4k` by default). As
in the reference, `--reduced` turns the products' exec-safe mode on
(`models.layers.set_exec_safe(True)`: f32 operands); the published config
trains with the default bf16 x bf16 -> f32 products.
Checkpoints land in `--ckpt-dir`, and a rerun with the same directory
resumes from the latest one.

With `--coordinator host:port` every process runs the same command in a
`torch.distributed` group over `tcp://host:port` (NCCL on a card, gloo on
the CPU) of `--num-processes` ranks, this one `--process-id` (else
`WORLD_SIZE` / `RANK` from the environment, as `torchrun` sets them). As
in the reference, each rank then trains the whole model with `NULL_RULES`
and no shardings on the same `(seed, step)` batches; a plain `--device
cuda` becomes the rank's card, `cuda:{rank % cards}`. Ranks on one host
need their own `--ckpt-dir`: ranks sharing one would clear each other's
checkpoint in flight.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from .._device import resolve_device
from ..configs import SHAPES_BY_NAME, get_config, list_archs, reduced
from ..configs.base import ShapeConfig


def world_and_rank(num_processes, process_id, environ=os.environ):
    """(world size, rank) of a `--coordinator` run: the flags, else
    `WORLD_SIZE` / `RANK` from `environ`; raises ValueError naming the flag
    when neither is set, or when the rank lies outside the world."""
    out = []
    for value, flag, var in ((num_processes, "--num-processes", "WORLD_SIZE"),
                             (process_id, "--process-id", "RANK")):
        if value is None:
            if environ.get(var) is None:
                raise ValueError(f"--coordinator needs {flag} (or {var} in "
                                 f"the environment)")
            value = int(environ[var])
        out.append(value)
    world, rank = out
    if not 0 <= rank < world:
        raise ValueError(f"--process-id {rank} is not a rank of "
                         f"--num-processes {world}")
    return world, rank


def rank_device(dev: torch.device, rank: int, n_cards: int) -> torch.device:
    """The device rank `rank` trains on: a CUDA device without an index
    becomes `cuda:{rank % n_cards}`; any other device is kept as given."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % n_cards)
    return dev


def _train(args, device):
    from ..models.layers import set_exec_safe
    from ..optim import adamw
    from ..train.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
        shape = ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")
        set_exec_safe(True)
    else:
        shape = SHAPES_BY_NAME[args.shape or "train_4k"]

    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, shape, tcfg=tcfg,
                      opt_cfg=adamw.AdamWConfig(lr=args.lr,
                                                total_steps=args.steps),
                      device=device)
    out = trainer.run()
    print(f"done: step {out['final_step']}, loss {out['losses'][-1]:.4f}, "
          f"stragglers {out['straggler_steps']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES_BY_NAME))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config + tiny shape (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"),
        help="checkpoint directory (auto-resume); each rank of a "
             "--coordinator run on one host needs its own")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's torch.distributed store; "
                         "every rank trains the whole model (ranks on one "
                         "host need their own --ckpt-dir)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; under "
                         "--coordinator, cuda is the rank's card)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)

    device = resolve_device(args.device)
    if not args.coordinator:
        return _train(args, device)

    import torch.distributed as dist

    world, rank = world_and_rank(args.num_processes, args.process_id)
    kw = {}
    if device.type == "cuda":
        device = rank_device(device, rank, torch.cuda.device_count())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{args.coordinator}",
                            world_size=world, rank=rank, **kw)
    try:
        out = _train(args, device)
        # rank 0 hosts the store: no rank leaves before every rank is done
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    main()
