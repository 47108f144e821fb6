#!/usr/bin/env python3
"""Where the DSE kernels' time goes: csrc/dse_eval.cu against cut-down
builds of itself (and, optionally, another commit's), timed in turns.

    python3 tools/stage_dse.py [--base DIR] [--rounds 5]

On one CUDA card. It compiles `src/repro_torch/kernels/csrc/dse_eval.cu`
as it is and with a stage cut out by the source's own stage macros:

  * `no-dominance` (`-DDSE_STAGE_NO_DOMINANCE`): the frontier kernels'
    step 4 (the dominance test) removed, every feasible lane counts as
    front;
  * `price-only` (`-DDSE_STAGE_PRICE_ONLY`): every frontier block takes the
    no-feasible-lane exit after step 1, so only the pricing of the lanes
    remains;
  * `decode-only` (`-DDSE_STAGE_DECODE_ONLY`): the search kernels read or
    decode their lanes and price nothing;
  * `hw-half` (`-DDSE_STAGE_HW_ONLY`): the search kernels price the
    area/power half and queue its survivors, and skip their dataflow half;
    kernel 1 prices its area/power half only;
  * `io-only` (`-DDSE_STAGE_IO_ONLY`): kernel 1 reads its configs and
    writes its four rows, pricing nothing;

and as a design build of kernel 1, with one choice of its design
undone: `k1-no-reuse` (`-DDSE_EVAL_NO_REUSE`: every GEMM's factors
computed, none reused from the previous GEMM; the parent's one lane a
thread is timed by `--base`);

and, with `--base DIR` (an unpacked copy of another commit, `git archive
<commit> | tar -x -C DIR`), that commit's `dse_eval.cu`. The cut builds' outputs are wrong by design; the source build is held
`torch.equal` to the base build (when given) on every case. It prints
ptxas's registers and the SASS instruction counts (`chip_smoke.
sass_counts`: shared, global and constant loads, conversions, software
divisions) of kernel 1's instances and the two search kernels in every
build. Each build's library is loaded with ctypes and put in turn in the repo's library cache, where
the wrappers find it, and every case is timed with CUDA events (a spin
kernel ahead of each window), the builds in turns, `--rounds` times; the
medians are printed. The operands are `chip_smoke.py`'s (`dse_inputs`):
kernels 1-2 and 5 on the 12^5 grid (deit-b; kernel 1 also on its columns
in a seeded random order, `k1 perm`, and one row short, `k1 short`, over
the whole 24^5 space and at bert-b's 24^5 Pareto BnB front, 166 rows;
kernel 2 also
with the five paper workloads in one launch, kernel 5 also on a block of
2048 duplicate rows), kernels 3, 4 and 6 on the whole 24^5 space
(kernel 3 also with the five workloads, the factorized `search_workloads` launch), kernels 3 and 6
on one 24^5 slab. Pricing's share of a frontier kernel is its
`price-only` time; the sort and the re-pricing of the sorted rows are
`no-dominance` less `price-only`; the dominance test is the source build
less `no-dominance`. A search kernel's decode (or config reads) is its
`decode-only` time, less the launch's fixed part; its area/power half is
`hw-half` less `decode-only`; its dataflow half is the source build less
`hw-half`. Kernel 1's reads and writes are its `io-only` time, its
area/power half `hw-half` less `io-only`, its GEMM loop the source build
less `hw-half`.
"""
import argparse
import contextlib
import ctypes
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

#: The cut-down builds: extra nvcc flags on the same source.
STAGES = {"source": (), "no-dominance": ("-DDSE_STAGE_NO_DOMINANCE",),
          "price-only": ("-DDSE_STAGE_PRICE_ONLY",),
          "io-only": ("-DDSE_STAGE_IO_ONLY",),
          "k1-no-reuse": ("-DDSE_EVAL_NO_REUSE",),
          "decode-only": ("-DDSE_STAGE_DECODE_ONLY",),
          "hw-half": ("-DDSE_STAGE_HW_ONLY",)}

#: Kernels whose SASS instruction counts are printed for every build.
SASS_KERNELS = ("dse_search_decoded_kernel", "dse_search_padded_kernel",
                "dse_eval_kernel")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("stage_dse: no CUDA device")
    from chip_smoke import dse_inputs, sass_counts
    from repro_torch.core.photonic_model import CONSTANTS
    from repro_torch.kernels import _build, dse_eval as dse

    out = _build.BUILD_DIR / "stage_dse"
    out.mkdir(parents=True, exist_ok=True)
    src = _build.CSRC / "dse_eval.cu"
    builds = {name: (src, flags) for name, flags in STAGES.items()}
    if args.base is not None:
        builds["base"] = (args.base / "src" / "repro_torch" / "kernels"
                          / "csrc" / "dse_eval.cu", ())
    jobs = {}
    for name, (cu, flags) in builds.items():
        so = out / f"lib{name}.so"
        jobs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS["dse_eval"], *flags, "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"stage_dse: {name} did not build\n{log}")
        kernel = None
        for line in log.splitlines():  # ptxas's registers of each kernel
            if "Compiling entry" in line:
                kernel = next((k for k in SASS_KERNELS if k in line), None)
            elif kernel is not None and "registers" in line:
                print(f"ptxas {name} {kernel}: "
                      f"{line.split(':', 1)[1].strip()}")
                kernel = None
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES["dse_eval"].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
        for kernel, c in (sass_counts(so, SASS_KERNELS) or {}).items():
            print(f"sass {name} {kernel}: "
                  + ", ".join(f"{k} {v}" for k, v in c.items()))

    dev = torch.device("cuda", 0)
    x = dse_inputs(dev)
    cols, mask, cons_row, carry = x.cols, x.mask, x.cons_row, x.carry
    gemms, wl_scalars, workloads = x.gemms, x.wl_scalars, x.workloads
    axes, radices, n, meta = x.axes, x.radices, x.n24, x.meta
    no_carry = torch.full((dse.CARRY_FRONT, 3), float("inf"), device=dev)
    pk = dict(workloads=workloads, objectives=("area", "power", "edp"),
              has_carry=False, constants=CONSTANTS)
    # the 12^5 columns in a seeded random order: quads whose lanes differ
    cols_perm = cols[:, torch.randperm(
        cols.shape[1], device=dev,
        generator=torch.Generator(device=dev).manual_seed(17))].contiguous()
    # one row short (G % 4 != 0): one lane a thread at a grid's size
    cols_short = cols[:, :-1].contiguous()
    cases = {
        "k1 12^5": lambda: dse.dse_eval_padded(
            cols, gemms=gemms, wl_scalars=wl_scalars, constants=CONSTANTS),
        "k1 perm": lambda: dse.dse_eval_padded(
            cols_perm, gemms=gemms, wl_scalars=wl_scalars,
            constants=CONSTANTS),
        "k1 short": lambda: dse.dse_eval_padded(
            cols_short, gemms=gemms, wl_scalars=wl_scalars,
            constants=CONSTANTS),
        "k1 24^5": lambda: dse.dse_eval_padded(
            x.cols24, gemms=gemms, wl_scalars=wl_scalars,
            constants=CONSTANTS),
        "k1 front": lambda: dse.dse_eval_padded(
            x.cols_front, gemms=x.gemms_front,
            wl_scalars=x.wl_scalars_front, constants=CONSTANTS),
        "k2 12^5": lambda: dse.dse_search_padded(
            cols, mask, cons_row, carry, workloads=workloads,
            constants=CONSTANTS),
        "k2 W5": lambda: dse.dse_search_padded(
            cols, mask, x.cons5, x.carry5, workloads=x.workloads5,
            constants=CONSTANTS),
        "k3 24^5": lambda: dse.dse_search_decoded(
            axes, meta, cons_row, carry, radices=radices,
            n_blocks=math.ceil(n / dse.DECODE_BLOCK), workloads=workloads,
            constants=CONSTANTS),
        "k3 W5": lambda: dse.dse_search_decoded(
            axes, meta, x.cons5, x.carry5, radices=radices,
            n_blocks=math.ceil(n / dse.DECODE_BLOCK),
            workloads=x.workloads5, constants=CONSTANTS),
        "k3 slab": lambda: dse.dse_search_decoded(
            axes, x.meta_s, cons_row, carry, radices=radices,
            n_blocks=math.ceil((x.b1 - x.b0) / dse.DECODE_BLOCK),
            workloads=workloads, constants=CONSTANTS),
        "k4 24^5": lambda: dse.dse_decode_rows(
            axes, meta, radices=radices, n_blocks=math.ceil(n / dse.BLOCK)),
        "k5 12^5": lambda: dse.dse_pareto_padded(
            cols, mask, cons_row, no_carry, **pk),
        "k5 dup": lambda: dse.dse_pareto_padded(
            x.cols_dup, x.mask_dup, cons_row, no_carry, **pk),
        "k6 24^5": lambda: dse.dse_pareto_decoded(
            axes, meta, cons_row, no_carry, radices=radices,
            n_blocks=math.ceil(n / dse.BLOCK), **pk),
        "k6 slab": lambda: dse.dse_pareto_decoded(
            axes, x.meta_s, cons_row, no_carry, radices=radices,
            n_blocks=math.ceil((x.b1 - x.b0) / dse.BLOCK), **pk),
    }
    @contextlib.contextmanager
    def use(name):
        """The wrappers launch build `name`'s kernels inside the block."""
        before = _build._LOADED.get("dse_eval")
        _build._LOADED["dse_eval"] = libs[name]
        try:
            yield
        finally:
            if before is None:
                _build._LOADED.pop("dse_eval")
            else:
                _build._LOADED["dse_eval"] = before

    if "base" in libs:
        for c, fn in cases.items():
            with use("base"):
                want = fn().clone()
            with use("source"):
                got = fn()
            if not torch.equal(got, want):
                sys.exit(f"stage_dse: the source build differs from the "
                         f"base build on {c}")
        print("source build equal to the base build on every case")

    def window(fn, inner):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / inner

    times = {name: {c: [] for c in cases} for name in libs}
    order = list(libs)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            with use(name):
                for c, fn in cases.items():
                    times[name][c].append(
                        window(fn, 3 if c == "k5 dup" else 10))
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"{smi.stdout.strip()}: median ms of {args.rounds} rounds, builds "
          f"in turns")
    print(f"{'build':14s}" + "".join(f"{c:>10s}" for c in cases))
    for name in libs:
        print(f"{name:14s}" + "".join(
            f"{statistics.median(times[name][c]):10.4f}" for c in cases))


if __name__ == "__main__":
    main()
