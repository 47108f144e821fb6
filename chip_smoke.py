#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card visible. It

  1. prints the card's name and power limit and builds the CUDA kernels from
     `src/repro_torch/kernels/csrc/` (nvcc, sm_90a);
  2. holds each of the six DSE kernels against its plain PyTorch version on
     the card, at the main path's shapes (the paper's 12^5 grid for the
     grid-operand kernels, the 24^5 product space and one slab of it for the
     decoded ones; the frontier kernels also with a carried front and with a
     block of 2048 duplicate rows that overflows MAX_FRONT), with
     `torch.equal`, and times both with CUDA events;
  3. drives the min-EDP co-search through the port's entry points:
     `search_workloads` over the five paper workloads on the 12^5 grid
     (cuda engine, hierarchical), checked against `tests/golden/dse_12x5.json`
     and the port's numpy engine; then `search(..., factorized=True,
     prune="bound")` on the 24^5 space, checked winner and counters against
     the numpy engine; then the legacy two-pass grid path and the on-device
     decode, the entry points of the other two search-side kernels;
  4. drives the Pareto-frontier co-search (`objective="pareto"`) the same
     way: `search_workloads` at 12^5 (hierarchical) and `search(...,
     factorized=True)` over the 12^5 product space, both checked against
     the golden frontiers and the numpy engine, then `search(...,
     factorized=True, prune="bound")` on the 24^5 space per paper workload,
     frontier and counters checked against the numpy engine;
  5. prints one JSON line with every kernel's launches (counted per
     entry-point call, the counts set to 0 just before each call and read
     just after it), its largest difference from its plain version, its
     time, its plain version's time and its bound, then the result line.

Any failed check raises, so the script exits non-zero and prints no result
line. It exits non-zero at once without a CUDA card, or outside a checkout.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM rate and the
# float32 rate outside the tensor cores. Integer operations of the cost model
# are counted at the float32 rate, which keeps the bound a lower bound.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Operations per config of the shared cost model (csrc/dse_eval.cu), each
# float32 or int32 add, multiply, divide, min/max, conversion and compare
# counted once: the hardware half with its two constraint compares; the
# dataflow half's fixed part, per-GEMM part and epilogue; the decoder.
HW_OPS = 54
WL_FIXED_OPS = 17
WL_PER_GEMM_OPS = 18
SEARCH_TAIL_OPS = 4      # energy/latency compares, EDP, argmin compare
PARETO_TAIL_OPS = 3      # energy/latency compares, EDP
DECODE_OPS = 29

REPLACES = {
    "dse_eval_padded": "src/repro/kernels/dse_eval.py:530",
    "dse_search_padded": "src/repro/kernels/dse_eval.py:550",
    "dse_search_decoded": "src/repro/kernels/dse_eval.py:663",
    "dse_decode_rows": "src/repro/kernels/dse_eval.py:716",
    "dse_pareto_padded": "src/repro/kernels/dse_eval.py:596",
    "dse_pareto_decoded": "src/repro/kernels/dse_eval.py:690",
}
SOURCE = "src/repro_torch/kernels/csrc/dse_eval.cu"


def _fail(msg: str):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    raise SystemExit(1)


def _check(ok: bool, msg: str):
    if not ok:
        _fail(msg)


def _time_ms(fn, reps: int = 7, inner: int = 5, spin: bool = True) -> float:
    """Device time of one call: the median over `reps` of the mean
    CUDA-event time of `inner` back-to-back calls, after a warm-up call.

    Each window starts behind a spin kernel that keeps the card busy for
    longer than the host takes to enqueue the window, so the events time
    the calls' kernels back to back, not the Python that launches them.
    `spin=False` drops it, for calls that wait on the card themselves (the
    frontier kernels' plain versions read sizes back to the host)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_cycles = int(4e9 * enqueue_s * inner) + 2_000_000  # ~2 GHz clock
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _max_abs_err(got, want) -> float:
    """Largest |got - want| in float64; equal elements (the same infinity,
    or NaN in both) count as 0."""
    import torch
    g, w = got.double(), want.double()
    same = (g == w) | (g.isnan() & w.isnan())
    diff = torch.where(same, torch.zeros_like(g), (g - w).abs())
    return float(diff.max()) if diff.numel() else 0.0


def _bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device is available; this script runs on the GPU")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        _fail(f"run from a checkout of the repository: {ROOT / 'src'} does "
              f"not hold the repro_torch package")
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import (Constraints, FactorizedSpace, config_grid,
                                  search, search_workloads)
    from repro_torch.core.factorized import slab_bounding_span, slab_indices
    from repro_torch.core.paper_workloads import PAPER_WORKLOADS, load
    from repro_torch.core.performance_model import workload_statics
    from repro_torch.core.photonic_model import CONSTANTS
    from repro_torch.kernels import dse_eval as dse
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import build_all

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"build: {build_all():.1f} s (nvcc, sm_90a, all sources)")

    names = sorted(PAPER_WORKLOADS)
    cons = Constraints()
    cons_row = torch.tensor([[cons.area_mm2, cons.power_w, cons.energy_j,
                              cons.latency_s]], dtype=torch.float32,
                            device=dev)
    carry = torch.full((1, 1), float("inf"), dtype=torch.float32,
                       device=dev)
    wl = load("deit-b")
    gemms, wl_scalars = workload_statics(wl, CONSTANTS)
    n_gemms = len(gemms)
    wl_ops = WL_FIXED_OPS + WL_PER_GEMM_OPS * n_gemms
    rows = {}

    def check_equal(name, got, want, shape):
        torch.cuda.synchronize()
        same_shape = got.shape == want.shape
        err = _max_abs_err(got, want) if same_shape else math.inf
        _check(same_shape and torch.equal(got, want),
               f"{name}: kernel output differs from its plain version at "
               f"{shape} (max abs err {err!r})")
        return err

    def measure(name, kernel, plain, n_bytes, n_ops, shape, plain_time):
        """Check one kernel run against its plain version and time both;
        `n_ops` may be a function of the kernel's output (work that
        depends on the data)."""
        got = kernel()
        err = check_equal(name, got, plain(), shape)
        if callable(n_ops):
            n_ops = n_ops(got)
        ms, plain_ms = _time_ms(kernel), plain_time(plain)
        bound, bound_by = _bound_ms(n_bytes, n_ops)
        print(f"{name} {shape}: equal to plain (max abs err {err!r}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({bound_by})")
        return got, {"shape": shape, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by}

    def record(name, kernel, plain, n_bytes, n_ops, shape,
               plain_time=_time_ms):
        got, m = measure(name, kernel, plain, n_bytes, n_ops, shape,
                         plain_time)
        rows[name] = {"name": name, "route": "cuda", "source": SOURCE,
                      "replaces": REPLACES[name], "launches": 0,
                      "launches_by_path": {}, "max_abs_err": m["max_abs_err"],
                      "ms": m["ms"], "plain_ms": m["plain_ms"],
                      "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                      "library_ms": None, "variants": []}
        return got

    def variant(name, kernel, plain, n_bytes, n_ops, shape,
                plain_time=_time_ms):
        """A further input of a recorded kernel: checked and timed the
        same way, kept under the kernel's "variants"."""
        got, m = measure(name, kernel, plain, n_bytes, n_ops, shape,
                         plain_time)
        rows[name]["variants"].append(m)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        m["max_abs_err"])
        return got

    def hw_pass(m):
        """Configs that pass area/power: the lanes the search kernels carry
        into the dataflow half (their early exit), in this run's data."""
        return int(((m[0] < cons.area_mm2) & (m[1] < cons.power_w)).sum())

    # -- kernels 1-2: the paper's 12^5 grid, deit-b -----------------------
    inc12 = list(range(1, 13))
    grid12 = config_grid(inc12, inc12, inc12, inc12, inc12)
    g = len(grid12)
    cols = torch.from_numpy(grid12.T.astype("float32")).contiguous().to(dev)
    metrics = record(
        "dse_eval_padded",
        lambda: dse.dse_eval_padded(cols, gemms=gemms, wl_scalars=wl_scalars,
                                    constants=CONSTANTS),
        lambda: dse.dse_eval_padded_plain(cols, gemms=gemms,
                                          wl_scalars=wl_scalars,
                                          constants=CONSTANTS),
        n_bytes=(5 + 4) * 4 * g, n_ops=g * (HW_OPS + wl_ops),
        shape=f"(5, {g}) deit-b")
    mask = torch.ones((1, g), dtype=torch.float32, device=dev)
    workloads = ((gemms, wl_scalars),)
    record(
        "dse_search_padded",
        lambda: dse.dse_search_padded(cols, mask, cons_row, carry,
                                      workloads=workloads,
                                      constants=CONSTANTS),
        lambda: dse.dse_search_padded_plain(cols, mask, cons_row, carry,
                                            workloads=workloads,
                                            constants=CONSTANTS),
        n_bytes=(5 + 1) * 4 * g + 3 * 4 * math.ceil(g / dse.BLOCK),
        n_ops=g * HW_OPS + hw_pass(metrics) * (wl_ops + SEARCH_TAIL_OPS),
        shape=f"(5, {g}) deit-b, {hw_pass(metrics)} pass area/power")

    # -- kernels 3-4: the whole 24^5 product space, then one slab ---------
    space24 = FactorizedSpace.full(24)
    axes, radices = ops._axes_operand(space24, dev)
    n24 = space24.size
    meta = torch.from_numpy(ops._meta_rows(radices, [0], n24)[0]).to(dev)
    nr = math.ceil(n24 / dse.BLOCK)
    decoded = record(
        "dse_decode_rows",
        lambda: dse.dse_decode_rows(axes, meta, radices=radices,
                                    n_blocks=nr),
        lambda: dse.dse_decode_rows_plain(axes, meta, radices=radices,
                                          n_blocks=nr),
        n_bytes=6 * 4 * nr * dse.BLOCK, n_ops=nr * dse.BLOCK * DECODE_OPS,
        shape=f"24^5 span [0, {n24})")
    pass24 = hw_pass(dse.dse_eval_padded(
        decoded[:5, :n24].contiguous(), gemms=gemms, wl_scalars=wl_scalars,
        constants=CONSTANTS))
    del decoded
    nb = math.ceil(n24 / dse.DECODE_BLOCK)
    record(
        "dse_search_decoded",
        lambda: dse.dse_search_decoded(axes, meta, cons_row, carry,
                                       radices=radices, n_blocks=nb,
                                       workloads=workloads,
                                       constants=CONSTANTS),
        lambda: dse.dse_search_decoded_plain(axes, meta, cons_row, carry,
                                             radices=radices, n_blocks=nb,
                                             workloads=workloads,
                                             constants=CONSTANTS),
        n_bytes=axes.numel() * 4 + 3 * 4 * nb,
        n_ops=(nb * dse.DECODE_BLOCK * DECODE_OPS + n24 * HW_OPS
               + pass24 * (wl_ops + SEARCH_TAIL_OPS)),
        shape=f"24^5 span [0, {n24}) deit-b, {pass24} pass area/power")
    slab = ((0, 3), (0, 4), (4, 20), (2, 18), (8, 16))
    b0, b1 = slab_bounding_span(radices, slab)
    meta_s = torch.from_numpy(ops._meta_rows(radices, [b0], b1, slab)[0]) \
        .to(dev)
    nb_s = math.ceil((b1 - b0) / dse.DECODE_BLOCK)
    nr_s = math.ceil((b1 - b0) / dse.BLOCK)
    kw = dict(radices=radices, n_blocks=nb_s, workloads=workloads,
              constants=CONSTANTS)
    slab_errs = {
        "dse_search_decoded": check_equal(
            "dse_search_decoded",
            dse.dse_search_decoded(axes, meta_s, cons_row, carry, **kw),
            dse.dse_search_decoded_plain(axes, meta_s, cons_row, carry, **kw),
            "a 24^5 slab"),
        "dse_decode_rows": check_equal(
            "dse_decode_rows",
            dse.dse_decode_rows(axes, meta_s, radices=radices, n_blocks=nr_s),
            dse.dse_decode_rows_plain(axes, meta_s, radices=radices,
                                      n_blocks=nr_s),
            "a 24^5 slab")}
    for name, err in slab_errs.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    print(f"24^5 slab {slab}, span [{b0}, {b1}): both decoded kernels "
          f"equal to plain")
    torch.cuda.empty_cache()

    # -- kernels 5-6: the frontier kernels, deit-b, (area, power, edp) ----
    golden = json.loads(
        (ROOT / "tests" / "golden" / "dse_12x5.json").read_text())
    objs = ("area", "power", "edp")
    d = len(objs)
    no_carry = torch.full((dse.CARRY_FRONT, d), float("inf"),
                          dtype=torch.float32, device=dev)
    # The carried front: the golden deit-b frontier, priced by the
    # dse_eval kernel in the frontier kernels' own float32 metric space.
    gold_b = golden["workloads"]["deit-b"]
    fm = dse.dse_eval_padded(
        torch.tensor(np.asarray(gold_b["front"], np.float32).T,
                     device=dev).contiguous(),
        gemms=gemms, wl_scalars=wl_scalars, constants=CONSTANTS)
    carry_front = no_carry.clone()
    carry_front[:fm.shape[1]] = torch.stack([fm[0], fm[1], fm[2] * fm[3]],
                                            dim=1)
    pk = dict(workloads=workloads, objectives=objs, constants=CONSTANTS)

    def dominance_ops(out, carried):
        """Pairwise compares of this run's data: f(f-1)/2 pairs of 2d
        compares per block of f feasible lanes, plus CARRY_FRONT * f pairs
        when a front is carried."""
        f = out[1].double()
        n = (f * (f - 1) / 2).sum() + (dse.CARRY_FRONT * f.sum()
                                       if carried else 0.0)
        return float(n) * 2 * d

    def padded_work(cols_, carried):
        """(bytes, ops function) of a padded frontier launch: 24 B read
        per padded lane, the output rows, the cost model, the compares."""
        n_pad = math.ceil(cols_.shape[1] / dse.BLOCK) * dse.BLOCK
        m = dse.dse_eval_padded(cols_, gemms=gemms, wl_scalars=wl_scalars,
                                constants=CONSTANTS)
        n_cost = cols_.shape[1] * HW_OPS + hw_pass(m) * (wl_ops
                                                         + PARETO_TAIL_OPS)
        n_bytes = (24 * n_pad + 4 * dse.PARETO_ROWS * n_pad // dse.BLOCK
                   + (4 * dse.CARRY_FRONT * d if carried else 0))
        return n_bytes, lambda out: n_cost + dominance_ops(out, carried)

    def plain_slow(fn):
        # The frontier plain versions read sizes back to the host per
        # batch of blocks, so the spin kernel would only add its own time.
        return _time_ms(fn, reps=3, inner=1, spin=False)

    for carried in (False, True):
        cr = carry_front if carried else no_carry
        n_bytes, n_ops = padded_work(cols, carried)
        (variant if carried else record)(
            "dse_pareto_padded",
            lambda cr=cr, c_=carried: dse.dse_pareto_padded(
                cols, mask, cons_row, cr, has_carry=c_, **pk),
            lambda cr=cr, c_=carried: dse.dse_pareto_padded_plain(
                cols, mask, cons_row, cr, has_carry=c_, **pk),
            n_bytes=n_bytes, n_ops=n_ops,
            shape=(f"(5, {g}) deit-b, "
                   + ("the golden front carried" if carried else "no carry")),
            plain_time=plain_slow)
    # A block of 2048 copies of the deit-b winner: 2048 exact ties, all on
    # the block's front, past MAX_FRONT; 300 grid rows follow.
    dup = np.concatenate([np.tile(np.asarray(gold_b["best"]),
                                  (dse.BLOCK, 1)), grid12[:300]])
    cols_dup = torch.from_numpy(dup.T.astype("float32")).contiguous().to(dev)
    mask_dup = torch.ones((1, len(dup)), dtype=torch.float32, device=dev)
    n_bytes, n_ops = padded_work(cols_dup, False)
    over = variant(
        "dse_pareto_padded",
        lambda: dse.dse_pareto_padded(cols_dup, mask_dup, cons_row, no_carry,
                                      has_carry=False, **pk),
        lambda: dse.dse_pareto_padded_plain(cols_dup, mask_dup, cons_row,
                                            no_carry, has_carry=False, **pk),
        n_bytes=n_bytes, n_ops=n_ops,
        shape=f"(5, {len(dup)}) deit-b, a block of {dse.BLOCK} duplicates",
        plain_time=plain_slow)
    _check(float(over[0, 0]) == dse.BLOCK > dse.MAX_FRONT,
           f"duplicate block: front count {float(over[0, 0])}, expected "
           f"{dse.BLOCK} (an overflow of MAX_FRONT)")
    np24 = math.ceil(n24 / dse.BLOCK)
    dk = dict(radices=radices, workloads=workloads, objectives=objs,
              constants=CONSTANTS)
    record(
        "dse_pareto_decoded",
        lambda: dse.dse_pareto_decoded(axes, meta, cons_row, no_carry,
                                       n_blocks=np24, has_carry=False, **dk),
        lambda: dse.dse_pareto_decoded_plain(axes, meta, cons_row, no_carry,
                                             n_blocks=np24, has_carry=False,
                                             **dk),
        n_bytes=axes.numel() * 4 + 4 * dse.PARETO_ROWS * np24,
        n_ops=lambda out: (np24 * dse.BLOCK * DECODE_OPS + n24 * HW_OPS
                           + pass24 * (wl_ops + PARETO_TAIL_OPS)
                           + dominance_ops(out, False)),
        shape=f"24^5 span [0, {n24}) deit-b, {pass24} pass area/power",
        plain_time=plain_slow)
    members = space24.decode(slab_indices(radices, slab))
    pass_s = hw_pass(dse.dse_eval_padded(
        torch.from_numpy(members.T.astype("float32")).contiguous().to(dev),
        gemms=gemms, wl_scalars=wl_scalars, constants=CONSTANTS))
    variant(
        "dse_pareto_decoded",
        lambda: dse.dse_pareto_decoded(axes, meta_s, cons_row, no_carry,
                                       n_blocks=nr_s, has_carry=False, **dk),
        lambda: dse.dse_pareto_decoded_plain(axes, meta_s, cons_row,
                                             no_carry, n_blocks=nr_s,
                                             has_carry=False, **dk),
        n_bytes=axes.numel() * 4 + 4 * dse.PARETO_ROWS * nr_s,
        n_ops=lambda out: (nr_s * dse.BLOCK * DECODE_OPS
                           + len(members) * HW_OPS
                           + pass_s * (wl_ops + PARETO_TAIL_OPS)
                           + dominance_ops(out, False)),
        shape=f"24^5 slab, {len(members)} members, {pass_s} pass area/power",
        plain_time=plain_slow)
    torch.cuda.empty_cache()

    def drive(path, fn, needs):
        """One call of a kernel path through its entry point, with every
        launch count set to 0 just before it and read just after; fails
        unless each kernel in `needs` was launched in that call."""
        dse.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(dse.LAUNCHES)
        for name in needs:
            _check(counts[name] > 0, f"{path}: never launched {name}")
        for name, n in counts.items():
            if n:
                rows[name]["launches"] += n
                rows[name]["launches_by_path"][path] = n
        print(f"{path}: launches {counts}")
        return out, wall

    # -- the main path: min-EDP co-search through the entry points --------
    wls = {n: load(n) for n in names}
    flat, t_flat = drive(
        "search_workloads 12^5 hierarchical",
        lambda: search_workloads(wls, cons, engine="cuda", hierarchical=True,
                                 device=dev),
        needs=("dse_search_padded",))
    ref = search_workloads(wls, cons, engine="numpy", hierarchical=True,
                           device=dev)
    for n in names:
        r, gold = flat[n], golden["workloads"][n]
        _check([int(x) for x in r.best_cfg.as_array()] == gold["best"]
               and r.edp == gold["edp"] and r.n_feasible == gold["n_feasible"],
               f"12^5 {n}: winner {r.best_cfg} edp {r.edp} n_feasible "
               f"{r.n_feasible} differ from the golden record")
        # n_workload_evals differs by design: the batched cuda launch
        # evaluates the union of the five workloads' area/power survivors.
        _check((r.best_cfg, r.edp, r.n_feasible)
               == (ref[n].best_cfg, ref[n].edp, ref[n].n_feasible),
               f"12^5 {n}: cuda and numpy engines disagree")
        print(f"12^5 hierarchical {n}: {r.best_cfg} edp {r.edp!r} "
              f"n_feasible {r.n_feasible} n_workload_evals "
              f"{r.n_workload_evals} — golden and numpy agree")
    print(f"search_workloads 12^5 (cuda, hierarchical, 5 workloads): "
          f"{t_flat:.3f} s")

    # The cuda query of each workload runs first and builds the process's
    # slab-bound tables for it (`cached_bound_evaluator`); the numpy query
    # and a second cuda query then find them built. Both warm times compare.
    keys = ("best_cfg", "edp", "n_feasible", "n_workload_evals", "n_pruned",
            "n_bounds")
    for n in names:
        def bnb(engine):
            return search(wls[n], cons, engine=engine, factorized=True,
                          space=space24, prune="bound", device=dev)
        r, t_cold = drive(f"search 24^5 prune=bound {n}",
                          lambda: bnb("cuda"),
                          needs=("dse_search_padded", "dse_search_decoded"))
        t0 = time.perf_counter()
        want = bnb("numpy")
        t_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = bnb("cuda")
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        for got in (r, again):
            _check(all(getattr(got, k) == getattr(want, k) for k in keys),
                   f"24^5 bound {n}: cuda "
                   f"{[getattr(got, k) for k in keys]} vs numpy "
                   f"{[getattr(want, k) for k in keys]}")
        print(f"24^5 prune=bound {n}: {r.best_cfg} edp {r.edp!r} "
              f"n_feasible {r.n_feasible} evaluated {r.n_workload_evals} "
              f"pruned {r.pruned_fraction:.6f} n_bounds {r.n_bounds}; "
              f"cuda {t_cold:.4f} s cold, {t_warm:.4f} s warm; numpy "
              f"{t_np:.4f} s warm")

    # -- the entry points of the other two kernels ------------------------
    (best_cfg, _), _ = drive(
        "cuda_grid_search 12^5 deit-b",
        lambda: ops.cuda_grid_search(grid12, wl, cons, device=dev),
        needs=("dse_eval_padded",))
    _check([int(x) for x in best_cfg.as_array()]
           == golden["workloads"]["deit-b"]["best"],
           "legacy two-pass grid search: deit-b winner differs")
    decoded, _ = drive(
        "decode_rows_device 24^5 slab",
        lambda: ops.decode_rows_device(space24, b0, b1 - b0, device=dev,
                                       slab=slab),
        needs=("dse_decode_rows",))
    _check(np.array_equal(decoded,
                          space24.decode(slab_indices(radices, slab))),
           "decode_rows_device: slab rows differ from the host decode")
    print(f"cuda_grid_search 12^5 deit-b: {best_cfg}; decode_rows_device "
          f"slab: {len(decoded)} rows")

    # -- the Pareto path: objective="pareto" through the entry points -----
    def same_front(got, want, keys=()):
        return (np.array_equal(got.front, want.front)
                and all(np.array_equal(got.metrics[k], want.metrics[k])
                        for k in want.metrics)
                and all(getattr(got, k) == getattr(want, k) for k in keys))

    def golden_front(r, n):
        gold = golden["workloads"][n]
        return ([[int(x) for x in row] for row in r.front] == gold["front"]
                and all([float(v) for v in r.metrics[k]]
                        == gold["front_metrics"][k]
                        for k in gold["front_metrics"])
                and r.n_feasible == gold["n_feasible"])

    fronts, t_pf = drive(
        "search_workloads 12^5 hierarchical pareto",
        lambda: search_workloads(wls, cons, engine="cuda", hierarchical=True,
                                 objective="pareto", device=dev),
        needs=("dse_pareto_padded",))
    t0 = time.perf_counter()
    ref_pf = search_workloads(wls, cons, engine="numpy", hierarchical=True,
                              objective="pareto", device=dev)
    t_pf_np = time.perf_counter() - t0
    for n in names:
        _check(golden_front(fronts[n], n),
               f"12^5 pareto {n}: the cuda frontier differs from the golden "
               f"record ({fronts[n].size} rows)")
        _check(same_front(fronts[n], ref_pf[n], ("n_feasible",)),
               f"12^5 pareto {n}: cuda and numpy engines disagree")
        print(f"12^5 hierarchical pareto {n}: {fronts[n].size} frontier "
              f"rows, n_feasible {fronts[n].n_feasible}, n_overflow "
              f"{fronts[n].n_overflow} — golden and numpy agree")
    print(f"search_workloads 12^5 pareto (hierarchical, 5 workloads): cuda "
          f"{t_pf:.4f} s, numpy {t_pf_np:.4f} s")
    space12 = FactorizedSpace.full(12)
    for n in names:
        r, t_fc = drive(
            f"search 12^5 factorized pareto {n}",
            lambda: search(wls[n], cons, engine="cuda", factorized=True,
                           space=space12, objective="pareto", device=dev),
            needs=("dse_pareto_decoded",))
        t0 = time.perf_counter()
        want = search(wls[n], cons, engine="numpy", factorized=True,
                      space=space12, objective="pareto", device=dev)
        t_fn = time.perf_counter() - t0
        _check(golden_front(r, n) and same_front(r, want, ("n_feasible",)),
               f"12^5 factorized pareto {n}: the cuda frontier differs from "
               f"the golden record or the numpy engine")
        print(f"12^5 factorized pareto {n}: {r.size} frontier rows, golden "
              f"and numpy agree; cuda {t_fc:.4f} s, numpy {t_fn:.4f} s")

    def float32_ties(got, want, wl_):
        """Mask of the numpy (float64) frontier rows the cuda frontier
        holds. Each row it lacks must be strictly dominated, in the
        kernels' float32 metrics (priced by the dse_eval kernel), by a row
        of the cuda frontier: the float32 edge `repro`'s pallas engine
        shares (two configs that tie in float32 but not in float64). Fails
        on any other difference: a cuda row the numpy frontier lacks, or a
        missing row with no float32 dominator."""
        have = {tuple(row) for row in got.front}
        held = np.asarray([tuple(row) in have for row in want.front], bool)
        _check(int(held.sum()) == got.size,
               "the cuda frontier holds a row the numpy frontier lacks")
        if held.all():
            return held

        def pts(rows):
            m = ops.dse_eval_grid(rows, wl_, device=dev)
            vals = {"area": m[:, 0], "power": m[:, 1], "energy": m[:, 2],
                    "latency": m[:, 3], "edp": m[:, 2] * m[:, 3]}
            return np.stack([vals[k] for k in objs], axis=1)

        front32 = pts(got.front)
        for p in pts(want.front[~held]):
            _check(bool((np.all(front32 <= p, axis=1)
                         & np.any(front32 < p, axis=1)).any()),
                   "a numpy frontier row is missing from the cuda frontier "
                   "without a float32 dominator in it")
        return held

    keys = ("n_feasible", "n_workload_evals", "n_pruned", "n_bounds")
    for n in names:
        def pbnb(engine):
            return search(wls[n], cons, engine=engine, factorized=True,
                          space=space24, prune="bound", objective="pareto",
                          device=dev)
        r, t_cold = drive(f"search 24^5 prune=bound pareto {n}",
                          lambda: pbnb("cuda"),
                          needs=("dse_pareto_decoded", "dse_pareto_padded",
                                 "dse_eval_padded"))
        t0 = time.perf_counter()
        want = pbnb("numpy")
        t_np = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = pbnb("cuda")
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        for got in (r, again):
            _check(all(getattr(got, k) == getattr(want, k) for k in keys)
                   and same_front(got, r),
                   f"24^5 bound pareto {n}: cuda {got.size} rows "
                   f"{[getattr(got, k) for k in keys]} vs numpy {want.size} "
                   f"rows {[getattr(want, k) for k in keys]}")
        held = float32_ties(r, want, wls[n])
        _check(np.array_equal(r.front, want.front[held])
               and all(np.array_equal(r.metrics[k], want.metrics[k][held])
                       for k in want.metrics),
               f"24^5 bound pareto {n}: frontier rows or metrics differ")
        if not held.all():
            print(f"24^5 prune=bound pareto {n}: numpy {want.size} frontier "
                  f"rows, cuda {r.size}; missing "
                  f"{want.front[~held].tolist()}, each strictly dominated "
                  f"in float32 by a cuda frontier row")
        print(f"24^5 prune=bound pareto {n}: {r.size} frontier rows, "
              f"n_feasible {r.n_feasible} evaluated {r.n_workload_evals} "
              f"pruned {r.pruned_fraction:.6f} n_bounds {r.n_bounds} "
              f"n_overflow {r.n_overflow}; cuda {t_cold:.4f} s cold, "
              f"{t_warm:.4f} s warm; numpy {t_np:.4f} s")

    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
