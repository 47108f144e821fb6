#!/usr/bin/env python3
"""`launch.train --coordinator` across every CUDA card of the host: one
process a rank, each on its own card.

    python3 tools/coordinator_ranks.py [--ranks N]

First one rank alone (`--num-processes 1`), then N ranks at once (N = the
cards present by default), each `python -m repro_torch.launch.train --arch
granite-3-2b --reduced --steps 4 --coordinator 127.0.0.1:<free port>
--num-processes N --process-id r --device cuda` with a checkpoint
directory of its own. Each rank reports the group's backend, its world
size and rank, the card it trained on and its losses. The script fails
unless every rank exits 0 in a NCCL group of N ranks on `cuda:{rank}`,
leaves no group up, and ends at the same step with losses within
`chip_smoke.TRAIN_LOSS_ATOL` of the one-rank run's. It prints each rank's
losses, whether they equal the one-rank run's bit for bit, and its wall
time (process start included), with the cards' names and power limits.
`--device cpu` runs the same on the CPU as gloo ranks (a rehearsal).
"""
import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 600
STEPS = 4
# One rank: `launch.train.main` with the group's state recorded where the
# trainer starts, and the result printed as one JSON line.
RANK_MAIN = """
import json, sys
import torch.distributed as dist
from repro_torch.launch import train
real, seen = train._train, {}
def _train(args, device):
    seen.update(backend=dist.get_backend(), world=dist.get_world_size(),
                rank=dist.get_rank(), device=str(device))
    return real(args, device)
train._train = _train
out = train.main(sys.argv[1:])
print("RESULT", json.dumps({**seen, "losses": out["losses"],
                            "final_step": out["final_step"],
                            "group_left_up": dist.is_initialized()}))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n, device, ckpt_root):
    """Ranks 0..n-1 of one group at once, each checkpointing under
    `ckpt_root/rank{r}`: [(result dict, wall s)]."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_MAIN, "--arch", "granite-3-2b",
         "--reduced", "--steps", str(STEPS), "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id",
         str(r), "--device", device, "--ckpt-dir",
         str(Path(ckpt_root) / f"rank{r}")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    deadline = time.monotonic() + TIMEOUT_S
    out = []
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            wall = time.perf_counter() - t0
            if p.returncode != 0:
                sys.exit(f"coordinator_ranks: rank {r} of {n} exited "
                         f"{p.returncode}\n{stdout}\n{stderr[-4000:]}")
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")][-1]
            out.append((json.loads(line[len("RESULT "):]), wall))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the group (default: the cards present)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()

    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    if args.device == "cuda":
        if not torch.cuda.is_available():
            sys.exit("coordinator_ranks: no CUDA device is available")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        hw = "; ".join(smi.splitlines())
        print(smi)
        cards = torch.cuda.device_count()
    else:
        hw, cards = "cpu", None
    n = args.ranks or cards or 2
    if cards is not None and n > cards:
        sys.exit(f"coordinator_ranks: {n} ranks need {n} cards, "
                 f"{cards} present (NCCL takes one card a rank)")
    backend = "nccl" if args.device == "cuda" else "gloo"
    print(f"cards: {cards}; ranks: {n}; backend: {backend}")

    with tempfile.TemporaryDirectory() as tmp:
        [(one, one_wall)] = run_ranks(1, args.device, Path(tmp) / "one")
        ranks = run_ranks(n, args.device, Path(tmp) / "group")
    print(f"one rank ({hw}): {one['device']}, losses {one['losses']}, "
          f"{one_wall:.2f} s")
    for r, (res, wall) in enumerate(ranks):
        want_dev = f"cuda:{r}" if args.device == "cuda" else "cpu"
        chip_smoke._check(
            (res["backend"], res["world"], res["rank"], res["device"])
            == (backend, n, r, want_dev),
            f"rank {r}: {res['backend']} group of {res['world']}, rank "
            f"{res['rank']} on {res['device']}; want {backend}, {n}, {r} "
            f"on {want_dev}")
        chip_smoke._check(not res["group_left_up"],
                          f"rank {r}: the process group is still up")
        d_loss = max(abs(a - b) for a, b in zip(res["losses"],
                                                one["losses"]))
        chip_smoke._check(
            res["final_step"] == one["final_step"] == STEPS
            and d_loss <= chip_smoke.TRAIN_LOSS_ATOL,
            f"rank {r}: step {res['final_step']}, losses {res['losses']} "
            f"against the one-rank run's {one['losses']} (within "
            f"{chip_smoke.TRAIN_LOSS_ATOL})")
        print(f"rank {r} of {n} ({res['backend']}, {res['device']}): losses "
              f"{res['losses']}, within {d_loss!r} of the one-rank run's, "
              f"bitwise equal: {res['losses'] == one['losses']}; "
              f"{wall:.2f} s")
    print(f"coordinator_ranks: {n} ranks ok ({hw})")


if __name__ == "__main__":
    main()
