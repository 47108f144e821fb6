#!/usr/bin/env python3
"""Where the time of one branch-and-bound query goes, on one CUDA card.

    python3 tools/trace_bnb.py [--workload deit-b] [--n-z 24] [--reps 5]
                               [--out build/trace_bnb]

Runs `search(..., factorized=True, prune="bound")` of the port on the
n_z^5 product space for one paper workload, with the cuda and the numpy
engine, after one untimed query of each (kernel build, slab-bound tables).
It prints

  * the warm wall time of each engine (median of `--reps` queries);
  * a `torch.profiler` trace of one warm cuda query: the device time of its
    kernels and copies against the query's wall time (the device's busy
    share), and the operators that take the most host time;
  * a `cProfile` of one warm query per engine: the host functions with the
    most cumulative time.

The full profiles and the Chrome trace go under `--out`.
"""
import argparse
import cProfile
import io
import pstats
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="deit-b")
    ap.add_argument("--n-z", type=int, default=24)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "build" / "trace_bnb"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("trace_bnb: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_us
    from repro_torch.core import Constraints, FactorizedSpace, search
    from repro_torch.core.paper_workloads import load
    from repro_torch.kernels import dse_eval as dse

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    wl, cons = load(args.workload), Constraints()
    space = FactorizedSpace.full(args.n_z)

    def query(engine):
        r = search(wl, cons, engine=engine, factorized=True, space=space,
                   prune="bound", device=dev)
        torch.cuda.synchronize()
        return r

    for engine in ("cuda", "numpy"):
        query(engine)
    for engine in ("cuda", "numpy"):
        ts = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            query(engine)
            ts.append(time.perf_counter() - t0)
        print(f"{args.workload} {args.n_z}^5 prune=bound, {engine} engine: "
              f"warm wall {statistics.median(ts):.4f} s (median of {args.reps}: "
              f"{[round(t, 4) for t in ts]})")

    dse.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        query("cuda")
        wall = time.perf_counter() - t0
    launches = dict(dse.LAUNCHES)
    prof.export_chrome_trace(str(out / "cuda_query.trace.json"))
    avgs = prof.key_averages()
    dev_us = sum(device_us(e) for e in avgs)
    print(f"profiled cuda query: wall {wall:.4f} s, launches {launches}, "
          f"device time {dev_us / 1e3:.4f} ms, device busy share "
          f"{dev_us / 1e6 / wall:.6f}" if dev_us else
          f"profiled cuda query: wall {wall:.4f} s, launches {launches}; "
          f"the profiler recorded no device time")
    for e in sorted(avgs, key=device_us, reverse=True)[:8]:
        if device_us(e):
            print(f"  device {device_us(e):10.1f} us  x{e.count:<5d} "
                  f"{e.key[:70]}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        print(f"  host   {e.self_cpu_time_total:10.1f} us  x{e.count:<5d} "
              f"{e.key[:70]}")
    (out / "cuda_query.key_averages.txt").write_text(
        avgs.table(sort_by="self_cpu_time_total", row_limit=60))

    for engine in ("cuda", "numpy"):
        pr = cProfile.Profile()
        pr.enable()
        query(engine)
        pr.disable()
        full = io.StringIO()
        pstats.Stats(pr, stream=full).sort_stats("cumulative") \
            .print_stats(60)
        (out / f"{engine}_query.cprofile.txt").write_text(full.getvalue())
        st = pstats.Stats(pr)
        rows = sorted(st.stats.items(), key=lambda kv: kv[1][3],
                      reverse=True)
        print(f"cProfile, {engine} engine, host functions by cumulative "
              f"time:")
        shown = 0
        for (fname, line, func), (_, ncalls, tt, ct, _) in rows:
            if "torch" not in fname and "numpy" not in fname:
                continue
            where = fname.split("src/")[-1].split("site-packages/")[-1]
            print(f"  cum {ct * 1e3:9.3f} ms  self {tt * 1e3:9.3f} ms  "
                  f"x{ncalls:<6d} {where}:{line} {func}")
            shown += 1
            if shown == 14:
                break


if __name__ == "__main__":
    main()
