#!/usr/bin/env python3
"""Where a dry-run cell's collectives and gathered ops come from.

    PYTHONPATH=src python3 tools/collective_sites.py --arch qwen2.5-3b \\
        --shape decode_32k [--mesh single|multi] [--device-type cpu] \\
        [--top 20]

Traces one cell as `python -m repro_torch.launch.dryrun` does (its depth
cuts, not extrapolated) and attributes every collective that
`analysis.collectives.CollectiveCounter` records, and every op that
`parallel.sharding.GatherFallback` reruns on gathered inputs, to the
innermost line of the port's model code on the stack (`models/`, else any
`repro_torch` file outside `analysis/` and `parallel/`:
`parallel.sharding.model_site`). It prints the sites by collective bytes a
card (kind, bytes, count), the gathered ops by site with the shape and
placements of their DTensor arguments, the views that flatten a sharded
dimension that does not lead its group by site
(`parallel.sharding.StridedViews`: a `_StridedShard` on torch 2.13, a
refusal and a retry on torch 2.11), then the cell's own totals.
"""
import argparse
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.analysis import collectives
    from repro_torch.launch import dryrun
    from repro_torch.parallel import sharding
    site = sharding.model_site

    by_site = defaultdict(lambda: [0, 0])     # (kind, site) -> bytes, count
    gathered = defaultdict(int)         # (op, site, arguments) -> count
    dispatch = collectives.CollectiveCounter.__torch_dispatch__
    retry = sharding._gathered_retry

    def counted(self, func, types, args=(), kwargs=None):
        n = len(self.events)
        out = dispatch(self, func, types, args, kwargs)
        if out is not NotImplemented:
            for kind, nbytes, _ in self.events[n:]:
                rec = by_site[(kind, site())]
                rec[0] += nbytes
                rec[1] += 1
        return out

    def retried(func, a, kw):
        shown = tuple(f"{tuple(x.shape)} {tuple(map(str, x.placements))}"
                      for x in a if hasattr(x, "placements"))
        gathered[(str(func), site(), shown)] += 1
        return retry(func, a, kw)

    strided = defaultdict(int)      # site -> count
    record = sharding.StridedViews._record

    def recorded(self):
        strided[site()] += 1
        record(self)

    collectives.CollectiveCounter.__torch_dispatch__ = counted
    sharding._gathered_retry = retried
    sharding.StridedViews._record = recorded
    cell = dryrun.run_cell(args.arch, args.shape, args.mesh == "multi",
                           device_type=args.device_type)
    total = sum(b for b, _ in by_site.values()) or 1
    print(f"{args.arch} {args.shape} {args.mesh}: collectives by site "
          f"(bytes a card over the traced depth cuts)")
    for (kind, where), (nbytes, n) in sorted(
            by_site.items(), key=lambda kv: -kv[1][0])[:args.top]:
        print(f"  {kind:12s} {nbytes:>16,d} B {nbytes / total:7.2%} "
              f"x{n:<5d} {where}")
    print("gathered ops by site:")
    for (op, where, shown), n in sorted(gathered.items(),
                                        key=lambda kv: -kv[1]):
        print(f"  {n:5d} {op} {where} {'; '.join(shown)}")
    print("strided views by site:")
    for where, n in sorted(strided.items(), key=lambda kv: -kv[1]):
        print(f"  {n:5d} {where}")
    print(f"cell: {cell['status']}, collectives {cell.get('collectives')}, "
          f"gathered {cell.get('replicated_ops')}, strided views "
          f"{sum((cell.get('strided_views') or {}).values())}")
    return 0 if cell["status"] != "error" else 1


if __name__ == "__main__":
    sys.exit(main())
