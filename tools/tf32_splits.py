#!/usr/bin/env python3
"""Time the TF32 attention kernel over its key splits, shape by shape.

    python3 tools/tf32_splits.py [--splits 1,2,3,4,6,7,8,16] [--rounds 5]

On one CUDA card. For each shape below (f32 operands from a seeded
generator) and each split count that the shape allows (at most one split
per 32-key tile, at most 64), it launches `flash_attention_tf32_launch`
of `csrc/flash_attention_tf32.cu` with that count directly (the wrapper
picks its own with `flash_attention.tf32_splits`), holds the result
within 2e-5 of the plain version, and times it with CUDA events
(`chip_smoke._time_ms`), the split counts in turns, `--rounds` times.
It prints the medians, the wrapper's choice and the time of
`scaled_dot_product_attention` on the same inputs.
"""
import argparse
import ctypes
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: (BH, S, D, group, causal): chip_smoke.py's f32 cases, and wider grids.
SHAPES = ((4, 256, 128, 1, False), (8, 200, 80, 4, True),
          (8, 200, 256, 4, True), (16, 512, 128, 1, False),
          (16, 512, 256, 4, True), (16, 1024, 128, 8, True),
          (32, 512, 128, 8, False), (64, 512, 64, 8, True))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="1,2,3,4,6,7,8,16")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("tf32_splits: no CUDA device")
    from chip_smoke import FLASH_TOL, _time_ms
    from repro_torch.kernels.flash_attention import (
        TF32_BLOCK_K, TF32_BLOCK_Q, flash_attention_bhsd_plain, tf32_splits)
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.dse_eval import _check, _ptr, _stream

    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = load_library("flash_attention_tf32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    counts = [int(x) for x in args.splits.split(",")]
    print(f"{torch.cuda.get_device_name(0)}, {n_sm} SMs: median ms of "
          f"{args.rounds} rounds, split counts in turns")
    for bh, s, d, group, causal in SHAPES:
        q = torch.randn((bh, s, d), generator=gen, device=dev)
        k = torch.randn((bh // group, s, d), generator=gen, device=dev)
        v = torch.randn((bh // group, s, d), generator=gen, device=dev)
        want = flash_attention_bhsd_plain(q, k, v, causal=causal,
                                          group=group)
        tiles = -(-s // TF32_BLOCK_K)
        ok = [n for n in counts if n <= min(tiles, 64)]

        def launch(n, out):
            part = (torch.empty(n * bh * s * (-(-d // 8) * 8 + 2),
                                device=dev) if n > 1 else None)
            _check(lib.flash_attention_tf32_launch(
                _ptr(q), _ptr(k), _ptr(v), _ptr(out), ctypes.c_int(bh),
                ctypes.c_int(s), ctypes.c_int(s), ctypes.c_int(d),
                ctypes.c_int(group), ctypes.c_int(int(causal)),
                ctypes.c_float(float(np.float32(d ** -0.5))),
                ctypes.c_int(0), ctypes.c_int(n),
                None if part is None else _ptr(part), _stream()),
                "flash_attention_tf32")
            return out

        outs = {n: torch.empty_like(q) for n in ok}
        for n in ok:
            got = launch(n, outs[n])
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=FLASH_TOL["torch.float32"],
                                  atol=FLASH_TOL["torch.float32"]):
                sys.exit(f"tf32_splits: {n} splits differ from the plain "
                         f"version at BH {bh}, S {s}, D {d}")
        times = {n: [] for n in ok}
        for r in range(args.rounds):
            for n in (ok if r % 2 == 0 else ok[::-1]):
                times[n].append(_time_ms(lambda n=n: launch(n, outs[n]),
                                         reps=3))
        sdpa = _time_ms(lambda: torch.nn.functional
                        .scaled_dot_product_attention(
                            q[None], k[None], v[None], is_causal=causal,
                            enable_gqa=group > 1))
        blocks = bh * -(-s // TF32_BLOCK_Q)
        print(f"BH {bh}, S {s}, D {d}, group {group}, "
              f"{'causal' if causal else 'bidirectional'} ({blocks} query "
              f"blocks; the wrapper takes "
              f"{tf32_splits(bh, s, s, d, n_sm)} splits): "
              + ", ".join(f"{n}: {statistics.median(times[n]):.4f}"
                          for n in ok) + f"; SDPA {sdpa:.4f}")


if __name__ == "__main__":
    main()
