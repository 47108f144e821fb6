#!/usr/bin/env python3
"""Where the time of token serving goes, on one CUDA card.

    python3 tools/trace_serve.py [--arch qwen2.5-3b] [--n-layers N]
                                 [--batch 4] [--max-len 64]
                                 [--out build/trace_serve]

Builds the port's model at the config's full published width (random bf16
weights from a seeded generator; `--n-layers` cuts the depth, never the
widths, for a model that does not fit the card, as deepseek-v3-671b at 4
layers in `chip_smoke.py`), serves `--batch` requests once untimed
(cuBLAS set-up), then traces one prefill and one decode step with
`torch.profiler` and prints, for each, the wall time (host clock around
work that ends in a sync), the device time of its kernels (the device's
busy share), the number of kernels it launched, and the kernels with the
most device time. Any decoder family serves; the enc-dec family needs
source frames, which `Server` does not send. The Chrome traces
and the full tables go under `--out`.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _device_us(evt) -> float:
    """Self device time of a profiler average that is a device event (a
    kernel or a copy), in microseconds, under either of the attribute names
    PyTorch versions use; 0 for host events. An operator's average carries
    its kernels' device time too, so summing every row would count each
    kernel twice (the profiler's own table sums device events only)."""
    from torch.autograd import DeviceType
    if evt.device_type != DeviceType.CUDA \
            or getattr(evt, "is_user_annotation", False):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to N layers (widths stay)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--out", default=str(ROOT / "build" / "trace_serve"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("trace_serve: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.train.serve import Request, Server, _grow_cache

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    if args.n_layers is not None:
        import dataclasses
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = models.init_params(cfg, gen, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=8).astype(np.int32)
               for _ in range(args.batch)]
    Server(cfg, params, args.batch, args.max_len, device=dev).generate(
        [Request(prompt=p, max_new=4) for p in prompts])
    tokens = torch.from_numpy(np.stack(prompts)).to(dev)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        state = {}

        def prefill():
            logits, cache = models.prefill(params, cfg, {"tokens": tokens})
            state["cache"] = _grow_cache(cache, args.max_len)
            state["tok"] = torch.argmax(logits, -1).to(torch.int32)[:, None]

        def decode():
            models.decode_step(params, cfg, state["tok"], tokens.shape[1],
                               state["cache"])

        for name, fn in (("prefill", prefill), ("decode_step", decode)):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            prof.export_chrome_trace(str(out / f"{name}.trace.json"))
            avgs = prof.key_averages()
            dev_us = sum(_device_us(e) for e in avgs)
            n_kernels = sum(e.count for e in avgs if _device_us(e))
            print(f"{args.arch} ({cfg.n_layers} layers) {name} (batch "
                  f"{args.batch}): wall {wall * 1e3:.3f} ms, device time "
                  f"{dev_us / 1e3:.3f} ms, device busy share "
                  f"{dev_us / 1e6 / wall:.4f}, {n_kernels} kernels"
                  if dev_us else f"{args.arch} {name}: wall "
                  f"{wall * 1e3:.3f} ms; the profiler recorded no device "
                  f"time")
            for e in sorted(avgs, key=_device_us, reverse=True)[:10]:
                if _device_us(e):
                    print(f"  device {_device_us(e):10.1f} us  "
                          f"x{e.count:<5d} {e.key[:80]}")
            (out / f"{name}.key_averages.txt").write_text(
                avgs.table(sort_by="self_cpu_time_total", row_limit=60))


if __name__ == "__main__":
    main()
