"""Render a baseline-vs-optimized roofline comparison of two dry-run sweeps
(the port of `repro/analysis/compare.py`, unchanged but for its module
path).

    PYTHONPATH=src python -m repro_torch.analysis.compare \
        results/dryrun_all.json results/dryrun_optimized.json
"""
from __future__ import annotations

import json
import sys


def key(c):
    return (c["arch"], c["shape"], c["mesh"])


def main():
    base_path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_all.json"
    opt_path = sys.argv[2] if len(sys.argv) > 2 \
        else "results/dryrun_optimized.json"
    base = {key(c): c for c in json.load(open(base_path))}
    opt = {key(c): c for c in json.load(open(opt_path))}
    rows = ["| arch | shape | mesh | frac (base) | frac (opt) | gain | "
            "t_coll base→opt | bottleneck (opt) |",
            "|---|---|---|---|---|---|---|---|"]
    gains = []
    for k in sorted(base):
        b, o = base[k], opt.get(k)
        if b["status"] != "ok" or o is None or o["status"] != "ok":
            continue
        rb, ro = b["roofline"], o["roofline"]
        fb, fo = rb["roofline_fraction"], ro["roofline_fraction"]
        gain = fo / fb if fb else float("inf")
        gains.append(gain)
        rows.append(
            f"| {k[0]} | {k[1]} | {k[2]} | {fb:.4f} | {fo:.4f} | "
            f"{gain:.1f}x | {rb['t_collective_s']:.2f}s → "
            f"{ro['t_collective_s']:.2f}s | {ro['bottleneck']} |")
    print("\n".join(rows))
    if gains:
        import statistics
        print(f"\ngeometric-mean gain: "
              f"{statistics.geometric_mean(gains):.2f}x over {len(gains)} "
              f"cells; best {max(gains):.1f}x, worst {min(gains):.2f}x")


if __name__ == "__main__":
    main()
