#!/usr/bin/env python3
"""The dry-run's sweep in both product modes, side by side.

    PYTHONPATH=src python3 tools/dryrun_modes.py --out-dir DIR \\
        [-- DRYRUN ARGUMENTS]

Runs `python -m repro_torch.launch.dryrun` with the given arguments (by
default `--all --mesh both`) twice, one process after the other: in the
default bf16 mode (the reference's: bf16 operands into the f32-result
product) into DIR/bf16.json, and with `models.layers.set_exec_safe(True)`
(f32 operands) into DIR/exec_safe.json. Then it prints, for every cell
traced in both, the trace seconds, the temp bytes (the peak live local
bytes, a lower bound), the collective bytes per card, the gathered ops
and the strided views (`parallel.sharding.StridedViews`) of each mode,
and the sweep's totals, with the cards' names and power limits when a
card is present; it writes the rows to DIR/compare.json.
It fails if a cell failed in either mode, if a cell's GEMM FLOPs differ
between the modes, or if a cell's collective bytes or gathered ops are
higher in bf16 mode. `--device-type cpu` among the dry-run arguments runs
without a card.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# The dry-run's `main` in exec-safe mode (the dry-run has no mode flag, as
# the reference's has none).
EXEC_SAFE_MAIN = ("import sys; from repro_torch.models import layers; "
                  "layers.set_exec_safe(True); "
                  "from repro_torch.launch.dryrun import main; "
                  "sys.exit(main(sys.argv[1:]))")
MODES = {"bf16": ["-m", "repro_torch.launch.dryrun"],
         "exec_safe": ["-c", EXEC_SAFE_MAIN]}


def sweep(mode, argv, out):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *MODES[mode], *argv, "--out",
                        str(out)], env=env, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    tail = r.stdout.strip().splitlines()[-1:] or [""]
    print(f"{mode}: exit {r.returncode}, {wall:.1f} s, {tail[0]}",
          flush=True)
    if not out.exists():
        raise SystemExit(f"{mode} sweep wrote nothing:\n{r.stderr[-4000:]}")
    return json.loads(out.read_text()), wall


def key(c):
    return c["arch"], c["shape"], c["mesh"]


def row(b, s):
    def gathered(c):
        return sum(c.get("replicated_ops", {}).values())

    def strided(c):
        return sum((c.get("strided_views") or {}).values())
    return {"arch": b["arch"], "shape": b["shape"], "mesh": b["mesh"],
            "status": [b["status"], s["status"]],
            **({} if b["status"] != "ok" or s["status"] != "ok" else {
                "trace_s": [b["compile_s"], s["compile_s"]],
                "temp_bytes": [b["memory"]["temp_size_in_bytes"],
                               s["memory"]["temp_size_in_bytes"]],
                "collective_bytes": [b["collectives"]["total"],
                                     s["collectives"]["total"]],
                "gemm_flops": [b["gemm_flops"], s["gemm_flops"]],
                "flops": [b["roofline"]["flops"], s["roofline"]["flops"]],
                "gathered_ops": [gathered(b), gathered(s)],
                "strided_views": [strided(b), strided(s)],
                "product_ops_gathered": sorted(
                    k for k in b["replicated_ops"]
                    if k in ("aten.mm.dtype", "aten.bmm.dtype"))})}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    rest = []
    if "--" in argv:
        i = argv.index("--")
        argv, rest = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser(prog="python3 tools/dryrun_modes.py")
    ap.add_argument("--out-dir", required=True)
    args = ap.parse_args(argv)
    rest = rest or ["--all", "--mesh", "both"]
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if "--device-type" not in rest or "cuda" in rest:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(smi.stdout.strip())
    cells, walls = {}, {}
    for mode in ("bf16", "exec_safe"):
        got, walls[mode] = sweep(mode, rest, out / f"{mode}.json")
        cells[mode] = {key(c): c for c in got}
    rows = [row(c, cells["exec_safe"][k]) for k, c in cells["bf16"].items()
            if k in cells["exec_safe"]]
    (out / "compare.json").write_text(json.dumps(rows, indent=1))
    print("arch shape mesh | trace s bf16 / exec-safe | temp bytes | "
          "collective bytes/card | gathered ops | strided views")
    for r in rows:
        if "trace_s" not in r:
            print(f"{r['arch']} {r['shape']} {r['mesh']} | {r['status']}")
            continue
        print(f"{r['arch']} {r['shape']} {r['mesh']} | "
              f"{r['trace_s'][0]:.1f} / {r['trace_s'][1]:.1f} | "
              f"{r['temp_bytes'][0]} / {r['temp_bytes'][1]} | "
              f"{r['collective_bytes'][0]} / {r['collective_bytes'][1]} | "
              f"{r['gathered_ops'][0]} / {r['gathered_ops'][1]} | "
              f"{r['strided_views'][0]} / {r['strided_views'][1]}")
    ok = [r for r in rows if "trace_s" in r]
    count = {m: {s: sum(c["status"] == s for c in cells[m].values())
                 for s in ("ok", "skipped", "error")} for m in cells}
    totals = {k: [sum(r[k][i] for r in ok) for i in (0, 1)]
              for k in ("trace_s", "temp_bytes", "collective_bytes",
                        "gathered_ops", "strided_views")}
    fell = sum(r["collective_bytes"][0] < r["collective_bytes"][1]
               for r in ok)
    print(f"cells bf16 {count['bf16']}, exec-safe {count['exec_safe']}; "
          f"over the {len(ok)} cells traced in both (bf16 / exec-safe): "
          f"trace {totals['trace_s'][0]:.1f} / {totals['trace_s'][1]:.1f} "
          f"s, temp {totals['temp_bytes'][0]} / {totals['temp_bytes'][1]} "
          f"B, collectives/card {totals['collective_bytes'][0]} / "
          f"{totals['collective_bytes'][1]} B (lower in {fell} cells), "
          f"gathered ops {totals['gathered_ops'][0]} / "
          f"{totals['gathered_ops'][1]}, strided views "
          f"{totals['strided_views'][0]} / {totals['strided_views'][1]}; "
          f"sweep walls "
          f"{walls['bf16']:.1f} / {walls['exec_safe']:.1f} s")
    bad = [f"{m} {k}: {c.get('error')}" for m in cells
           for k, c in cells[m].items() if c["status"] == "error"]
    for r in ok:
        name = f"{r['arch']} {r['shape']} {r['mesh']}"
        if r["gemm_flops"][0] != r["gemm_flops"][1]:
            bad.append(f"{name}: GEMM FLOPs {r['gemm_flops']}")
        if r["collective_bytes"][0] > r["collective_bytes"][1]:
            bad.append(f"{name}: collective bytes {r['collective_bytes']}")
        if r["gathered_ops"][0] > r["gathered_ops"][1] \
                or r["product_ops_gathered"]:
            bad.append(f"{name}: gathered ops {r['gathered_ops']} "
                       f"{r['product_ops_gathered']}")
    if bad:
        raise SystemExit("bf16 mode against exec-safe:\n" + "\n".join(bad))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
