"""Render the dry-run/roofline results JSON into Markdown tables (the port
of `repro/analysis/report.py`, unchanged but for its module path).

    PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun_all.json
"""
from __future__ import annotations

import json
import sys
from typing import List


def _fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def _fmt_t(s):
    if s is None:
        return "-"
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.2f}ms"
    return f"{s*1e6:.1f}us"


def dryrun_table(cells: List[dict]) -> str:
    rows = ["| arch | shape | mesh | status | compile | HLO FLOPs | "
            "HLO bytes | coll. bytes/chip | HBM/chip (args+tmp) |",
            "|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["status"] != "ok":
            reason = c.get("reason", c.get("error", ""))[:60]
            rows.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                        f"{c['status']}: {reason} | - | - | - | - | - |")
            continue
        r = c["roofline"]
        mem = c.get("memory", {})
        hbm = None
        if mem:
            hbm = mem.get("argument_size_in_bytes", 0) \
                + mem.get("temp_size_in_bytes", 0) \
                - mem.get("alias_size_in_bytes", 0)
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | ok | "
            f"{c['compile_s']:.0f}s | {r['flops']:.3g} | "
            f"{r['hbm_bytes']:.3g} | "
            f"{_fmt_bytes(r['collective_bytes_per_chip'])} | "
            f"{_fmt_bytes(hbm)} |")
    return "\n".join(rows)


def roofline_table(cells: List[dict]) -> str:
    rows = ["| arch | shape | mesh | t_compute | t_memory | t_collective | "
            "bottleneck | useful-FLOPs | roofline frac |",
            "|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["status"] != "ok":
            continue
        r = c["roofline"]
        uf = r.get("useful_flops_ratio")
        rf = r.get("roofline_fraction")
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
            f"{_fmt_t(r['t_compute_s'])} | {_fmt_t(r['t_memory_s'])} | "
            f"{_fmt_t(r['t_collective_s'])} | **{r['bottleneck']}** | "
            f"{uf:.3f} | {rf:.4f} |" if uf is not None and rf is not None
            else f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                 f"{_fmt_t(r['t_compute_s'])} | {_fmt_t(r['t_memory_s'])} | "
                 f"{_fmt_t(r['t_collective_s'])} | **{r['bottleneck']}** | "
                 f"- | - |")
    return "\n".join(rows)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_all.json"
    cells = json.load(open(path))
    print("### Dry-run table\n")
    print(dryrun_table(cells))
    print("\n### Roofline table\n")
    print(roofline_table(cells))


if __name__ == "__main__":
    main()
