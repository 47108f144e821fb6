#!/usr/bin/env python3
"""Two dry-run sweeps side by side, cell by cell: collective bytes a card by
kind, GEMM FLOPs, bottleneck and gathered ops.

    python3 tools/dryrun_diff.py BASE.json NEW.json [--check] \
        [--may-move KIND,...]

BASE and NEW are `python -m repro_torch.launch.dryrun --out` files (or
`tools/dryrun_modes.py`'s `bf16.json` / `exec_safe.json`). For every cell
traced in both it prints the all-gather, all-reduce, reduce-scatter and
total bytes a card (GB) before and after, the total's relative change,
whether the GEMM FLOPs are equal, and the bottleneck before and after;
then the cell counts by status in each file. With `--check` it fails if a cell's status differs,
if GEMM FLOPs differ in any cell, if a decode cell's (decode_32k,
long_500k) all-gather bytes rose, or if a train or prefill cell's
collective bytes of any kind moved by more than 0.1 %, apart from the
kinds `--may-move` names (a change to how train and prefill cells reduce).
"""
import argparse
import json
import sys
from collections import Counter

DECODE = ("decode_32k", "long_500k")
TOLERANCE = 1e-3  # train and prefill cells: relative change per kind


def key(c):
    return c["arch"], c["shape"], c["mesh"]


def gb(c, kind):
    return c["collectives"].get(kind, 0) / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base")
    ap.add_argument("new")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--may-move", default="",
                    help="comma-separated collective kinds a train or "
                         "prefill cell may move by more than 0.1 %%")
    args = ap.parse_args(argv)
    may_move = set(filter(None, args.may_move.split(",")))
    base = {key(c): c for c in json.load(open(args.base))}
    new = {key(c): c for c in json.load(open(args.new))}
    faults = []
    print("arch shape mesh | all-gather GB | all-reduce GB | "
          "reduce-scatter GB | total GB (change) | GEMM FLOPs | bottleneck "
          "| gathered ops")
    for k in sorted(base.keys() & new.keys()):
        b, n = base[k], new[k]
        if b["status"] != n["status"]:
            faults.append(f"{k}: status {b['status']} -> {n['status']}")
        if b["status"] != "ok" or n["status"] != "ok":
            continue
        tb, tn = gb(b, "total"), gb(n, "total")
        change = (tn - tb) / tb if tb else 0.0
        same_gemm = b["gemm_flops"] == n["gemm_flops"]
        print(f"{' '.join(k)} | {gb(b, 'all-gather'):.6g} -> "
              f"{gb(n, 'all-gather'):.6g} | {gb(b, 'all-reduce'):.6g} -> "
              f"{gb(n, 'all-reduce'):.6g} | {gb(b, 'reduce-scatter'):.6g} "
              f"-> {gb(n, 'reduce-scatter'):.6g} | {tb:.6g} -> {tn:.6g} "
              f"({change:+.3%}) | {'equal' if same_gemm else 'DIFFER'} | "
              f"{b['roofline']['bottleneck']} -> "
              f"{n['roofline']['bottleneck']} | "
              f"{sum(b.get('replicated_ops', {}).values())} -> "
              f"{sum(n.get('replicated_ops', {}).values())}")
        if not same_gemm:
            faults.append(f"{k}: GEMM FLOPs {b['gemm_flops']} -> "
                          f"{n['gemm_flops']}")
        if k[1] in DECODE:
            if gb(n, "all-gather") > gb(b, "all-gather"):
                faults.append(f"{k}: all-gather rose")
        else:
            for kind in (set(b["collectives"]) | set(n["collectives"])) \
                    - may_move - {"total"}:
                x, y = gb(b, kind), gb(n, kind)
                if abs(y - x) > TOLERANCE * max(x, y):
                    faults.append(f"{k}: {kind} {x:.6g} -> {y:.6g} GB")
    for name, cells in (("base", base), ("new", new)):
        counts = Counter(c["status"] for c in cells.values())
        print(f"{name}: {counts.get('ok', 0)} ok, "
              f"{counts.get('skipped', 0)} skipped, "
              f"{counts.get('error', 0)} failed")
    for f in faults:
        print("FAULT", f)
    return 1 if args.check and faults else 0


if __name__ == "__main__":
    sys.exit(main())
