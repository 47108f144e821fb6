"""Train a small LM for a few steps with the port's trainer (PyTorch):
`examples/train_photonic_qat.py`'s model, schedule and checks on
`repro_torch`.

It exercises the training substrate end to end — AdamW, checkpointing
every 10 steps, auto-resume (run it twice with the same --ckpt-dir to
continue), step-deterministic data — and checks that the loss falls. As the
reference's example does, it turns the products' exec-safe mode on
(`set_exec_safe(True)`: f32 operands). The products do not pass through
the 4-bit DDot quantization (`kernels.ops.photonic_matmul`), here nor in
the reference's trainer.

    PYTHONPATH=src python examples/train_photonic_qat_torch.py --steps 30
    # on the card by default; --device cpu runs it here
"""
import argparse
import os
import tempfile

from repro_torch.configs import ModelConfig
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.layers import set_exec_safe
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_qat_ckpt"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    args = ap.parse_args(argv)
    set_exec_safe(True)

    cfg = ModelConfig(name="qat-lm", family="dense", n_layers=args.layers,
                      d_model=args.d_model, n_heads=max(4, args.d_model // 32),
                      n_kv_heads=max(2, args.d_model // 64), head_dim=32,
                      d_ff=args.d_model * 4, vocab=2048)
    shape = ShapeConfig("train", seq_len=args.seq, global_batch=args.batch,
                        kind="train")
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=10,
                         ckpt_dir=args.ckpt_dir)
    trainer = Trainer(cfg, shape, tcfg=tcfg,
                      opt_cfg=adamw.AdamWConfig(lr=1e-3, warmup_steps=10,
                                                total_steps=args.steps),
                      device=args.device)
    if trainer.start_step:
        print(f"resumed from checkpoint at step {trainer.start_step}")
    out = trainer.run()
    losses = out["losses"]
    print(f"steps {trainer.start_step}..{out['final_step']}  "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}  "
          f"stragglers={out['straggler_steps']}")
    assert losses[-1] < losses[0], "loss should decrease"
    print("checkpoints in", args.ckpt_dir)
    return out


if __name__ == "__main__":
    main()
