#!/usr/bin/env python3
"""`shard=` across every CUDA card the process sees: `chip_smoke.py`'s phase
4f alone, with each kernel launch's card recorded.

    python3 tools/shard_fanout.py [--n-z 24]

Builds `csrc/dse_eval.cu`, then runs `chip_smoke.shard_phase` on the n_z^5
space: every sharded search, service query and launcher run byte for byte
equal to the same call at shard=None, and the k = 4 layout of kernels 2,
3, 5 and 6 on card 0 equal to the unsharded launch. With several cards,
`shard=4` spans k = min(4, cards) of them, so the sharded calls launch on
cards 0..k-1 (shard=2: 0..1): the script fails unless each sharded
cuda-engine call launched a kernel on every one of them, and each
shard=None call and the k = 4 layout on card 0 only. It prints each
call's launches by card and wall time beside shard=None's, with the
cards' names and power limits. On one card it is phase 4f as
`chip_smoke.py` runs it.
"""
import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-z", type=int, default=24)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("shard_fanout: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import dse_eval as dse
    from repro_torch.kernels._build import build_all
    from repro_torch.launch.mesh import make_candidate_mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    hw = "; ".join(smi.splitlines())
    print(smi)
    print(f"cards: {torch.cuda.device_count()}; build: "
          f"{build_all(('dse_eval',))}")
    dev = torch.device("cuda", 0)
    n_cards = torch.cuda.device_count()
    k = len(make_candidate_mesh(4, dev))

    # Record the card of every kernel launch (the wrappers launch through
    # dse_eval._launch, which makes the operands' card current).
    cards = []
    real_launch = dse._launch

    def launch(device, entry, *a):
        cards.append(torch.device(device).index)
        return real_launch(device, entry, *a)

    dse._launch = launch

    def drive(label, fn, needs):
        for name in dse.LAUNCHES:
            dse.LAUNCHES[name] = 0
        del cards[:]
        t0 = time.perf_counter()
        out = fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        wall = time.perf_counter() - t0
        counts = dict(dse.LAUNCHES)
        for name in needs:
            chip_smoke._check(counts[name] > 0,
                              f"{label}: never launched {name}")
        by_card = {c: cards.count(c) for c in sorted(set(cards))}
        shard = re.search(r"shard(?:': |=| )(\d+)", label)
        want = ([0] if shard is None else
                list(range(min(int(shard.group(1)), n_cards))))
        if needs:
            chip_smoke._check(sorted(by_card) == want,
                              f"{label}: launched on cards {by_card}, not "
                              f"on each of {want}")
        print(f"{label}: launches by card {by_card}")
        return out, wall, counts

    inp = chip_smoke.dse_inputs(dev)
    t0 = time.perf_counter()
    walls = chip_smoke.shard_phase(dev, args.n_z, hw, drive, inp)
    print(f"shard_fanout: k = {k}, {len(walls)} calls in "
          f"{time.perf_counter() - t0:.1f} s ({hw})")


if __name__ == "__main__":
    main()
