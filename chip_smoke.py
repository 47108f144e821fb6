#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card visible. It

  1. prints the card's name and power limit and builds the CUDA kernels from
     `src/repro_torch/kernels/csrc/` (nvcc, sm_90a, one process per source,
     all started together), printing each source's build seconds,
     ptxas's registers and spills of each kernel and, where `cuobjdump` is
     present, the SASS instruction counts of the two min-EDP search
     kernels;
  2. holds each of the six DSE kernels against its plain PyTorch version on
     the card, at the main path's shapes (the paper's 12^5 grid for the
     grid-operand kernels, the 24^5 product space and one slab of it for the
     decoded ones; kernel 1 also over the whole 24^5 space and at the
     running front the Pareto BnB prices, with the wall time of one
     `ops.dse_eval_grid` call there; the search kernels also with the five
     paper workloads in one launch; the frontier kernels also with a carried front, with a
     block of 2048 duplicate rows that overflows MAX_FRONT, and at a clock
     slow enough that EDP overflows to +inf on feasible lanes, which makes
     a block sort all its lanes), with `torch.equal`, and times both with
     CUDA events;
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
  4b. drives the `torch` engine (plain torch float32 on the card, the
     reference's `jax` engine): `search_workloads` over the five paper
     workloads on the 12^5 grid in both objectives against the golden
     record and the numpy engine, one streamed and one factorized query,
     and the 24^5 `prune="bound"` query for deit-b in both objectives
     (every counter, the winner and the frontier equal numpy's); holds its
     float32 metrics on a 24^5 slab equal to its CPU run bit for bit,
     fails if any hand-written kernel launched in the phase, and prints
     warm wall times beside numpy's and cuda's;
  4c. drives the resident DSE service (`repro_torch.serve.SearchService`,
     cuda engine, 24^5 space; `service_phase`): the five paper workloads
     cold (min-EDP), two tightened boxes each warm, a memo repeat and one
     submit/drain batch of the five under a looser box; deit-b and bert-b
     Pareto cold then warm; a robust node45 worst-case query; the resilient
     runtime (a service checkpoint root resumed by a restarted service, a
     24^5 BnB killed at a checkpoint and resumed byte-identically, an
     injected launch failure retried to the same answer; launch failures
     past the retries and a NaN block each failing the search, as on a
     card no unit falls back to another engine or to the host); the `dse`
     launcher in-process. Answers equal the
     numpy engine's, the service's stats a numpy service's; every query
     without an injected fault shows no retry, fallback or quarantine, and
     every cold query launched kernels 3 and 2 (min-EDP) or 6, 5 and 1
     (Pareto). It prints each query's wall time beside the card's name and
     power limit;
  4d. sweeps the model zoo (`repro_torch.scenarios`, `scenario_phase`): all
     10 archs at their published configs x train, prefill and decode of
     16 and 64 tokens at seq 2048, batch 8 (40 scenarios) through one cuda
     service on the 24^5 space, under per-class boxes (decode
     latency_ms=2), again from the memo (no launch), and under the
     area/power box alone; a Pareto sweep of three archs; the `scenarios`
     launcher with its defaults. Winners, frontiers, counters, stats and
     report text equal numpy- and torch-engine services' sweeps;
  4e. drives the parallel slab scheduler (`search(..., workers=N)`,
     `workers_phase`): the five paper workloads on 24^5 in both objectives
     with workers=None, 1, 4 and 4 asynchronous, equal in answers and
     canonical counters; a kill, a raise and a timeout at a lease; a
     checkpointed workers=4 query killed and resumed under workers=1; a
     workers=4 service's cold and warm queries. Every call's launch counts
     equal a second count kept per launching thread, and it prints each
     call's wall time, launches and threads;
  5. holds the two LM kernels against their plain versions on the card:
     `ddot_gemm_quantized` (the photonic 4-bit GEMM, int8 tensor cores)
     `torch.equal` at the qwen2.5-3b LM head (4 x 2048 x 151,936, B
     K-major as the head's transposed table gives it, no copy), its MLP
     up-projection (256 x 2048 x 11,008, B in both layouts; the wrapper's
     K-major copy of a row-major B timed on its own line) and a ragged
     shape in both layouts, without and with shot noise (the same explicit
     z); `flash_attention_bhsd` within the reference's tolerance (2e-5 f32,
     2e-2 bf16) at qwen2.5-3b attention (S = 4096, 16 query and 2 KV heads,
     D = 128, bf16, causal) and at small bf16 cases with D = 56, 64, 80,
     112 and 256 and a bidirectional one, all on the wgmma kernel, and
     f32 cases (D = 128 bidirectional, 80, 256 with the keys split across
     CTAs; D = 128 and 256 at BH 16, S = 512, and D = 128 at BH 32, the
     last two with one split) and a bf16 D = 36 case on the TF32 mma.sync
     kernel; each case asserts through
     `LAUNCHES` which of the two kernels ran;
  6. serves tokens from qwen2.5-3b at its full published width (random
     weights from a seeded generator): `Server(batch_size=4, max_len=64)`
     answers 4 requests of 12 new tokens, prefill logits are checked
     finite, a reduced qwen2.5-3b is held against the port's CPU path, the
     photonic LM head runs through `photonic_matmul` (noise 0.02 and 0),
     `photonic_report` prices the workload, and `kernels.flash_attention`
     runs at the attention shape above (bf16, the wgmma kernel) and at
     S = 512 in f32 (the TF32 kernel);
  6b. serves each other model family at its published widths
     (`families_phase`; random weights from a seeded generator, one model
     resident at a time): olmoe-1b-7b, zamba2-7b, rwkv6-7b and
     seamless-m4t-medium whole, deepseek-v3-671b cut to 4 layers (3 dense
     MLA layers, one MoE layer of 256 experts, MTP). Per family: the
     reduced model on the card within LOGIT_ATOL of the port's CPU path
     (prefill and one decode step), the build, a prefill whose cache keys
     have `init_cache`'s layout, 4 requests x 12 new tokens twice through
     `Server` (the enc-dec family greedily through
     `models.prefill`/`decode_step` with 64 source frames), `forward` and
     `lm_loss` on a (4, 16) batch (finite; deepseek's `mtp_logits` too),
     the peak device memory, `photonic_report` at the published config; no
     hand-written kernel may launch;
  7. prints one JSON line with every kernel's launches (counted per
     entry-point call, the counts set to 0 just before each call and read
     just after it), its largest difference from its plain version, its
     time, its plain version's time, its bound (bytes at the HBM rate, or
     operations: FLOPs at the published peaks for the LM kernels,
     instructions at the SM issue rate for the DSE kernels) and, where one
     PyTorch call computes the same function, that call's time; then the
     result line.

Any failed check raises, so the script exits non-zero and prints no result
line. It exits non-zero at once without a CUDA card, or outside a checkout.
"""
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM rate, the
# float32 rate outside the tensor cores (an FMA counted as two FLOPs: the
# yardstick of the attention rows, which count FLOPs), and the dense
# tensor-core rates for int8 and bf16.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
# The DSE kernels' operations are instructions: the cost model is built with
# -fmad=false, so no add fuses into a multiply, and an SM issues at most one
# float32 (or int32) instruction per lane per clock on its 128 lanes. Their
# rate is SMs x F32_LANES_PER_SM x the SM clock that nvidia-smi reports as
# clocks.max.sm in the run; integer operations counted at that rate keep
# the bound a lower bound.
F32_LANES_PER_SM = 128

# Operations per config of the shared cost model (csrc/dse_eval.cu), each
# float32 or int32 add, multiply, divide, min/max, conversion and compare
# counted once: the hardware half, split into the terms above lambda
# (upper_terms), the lambda terms of the area and power sums
# (hw_prefix_lane) and a workload's tail (two SRAM and two chip terms and
# the two constraint compares; a further workload of the same launch adds
# only its tail); the dataflow half's fixed part, per-GEMM part and
# epilogue; the decoder (digits and slab test of a lane from its index).
UPPER_OPS = 22
LANE_HW_OPS = 26
HW_TAIL_OPS = 6
HW_OPS = UPPER_OPS + LANE_HW_OPS + HW_TAIL_OPS
WL_FIXED_OPS = 17
WL_PER_GEMM_OPS = 18
SEARCH_TAIL_OPS = 4      # energy/latency compares, EDP, argmin compare
PARETO_TAIL_OPS = 3      # energy/latency compares, EDP
DECODE_OPS = 29
# A decoded launch needs less than a full decode and hardware half a lane:
# a walk over runs of RUN_LANES consecutive lanes (what dse_search_decoded
# does, bit for bit) decodes fully once a run, then steps the digits
# (STEP_OPS: lambda's increment and compare) and tests the lane's span and
# lambda range (SLAB_LANE_OPS); where lambda wraps inside a run it carries
# (CARRY_OPS) and tests the upper digits' ranges (SLAB_UPPER_OPS); the
# terms above lambda are priced once a run and upper digits.
RUN_LANES = 8
STEP_OPS = 2
SLAB_LANE_OPS = 3
CARRY_OPS = 10
SLAB_UPPER_OPS = 8

# The kernels, each with the TPU kernel it replaces. Two CUDA kernels
# replace flash_attention_bhsd: the wgmma one (bf16, D % 8 == 0) and the
# TF32 mma.sync one (f32, other head dims); each has its own row.
REPLACES = {
    "dse_eval_padded": "src/repro/kernels/dse_eval.py:530",
    "dse_search_padded": "src/repro/kernels/dse_eval.py:550",
    "dse_search_decoded": "src/repro/kernels/dse_eval.py:663",
    "dse_decode_rows": "src/repro/kernels/dse_eval.py:716",
    "dse_pareto_padded": "src/repro/kernels/dse_eval.py:596",
    "dse_pareto_decoded": "src/repro/kernels/dse_eval.py:690",
    "ddot_gemm_quantized": "src/repro/kernels/ddot_gemm.py:61",
    "flash_attention_bhsd": "src/repro/kernels/flash_attention.py:70",
    "flash_attention_bhsd_tf32": "src/repro/kernels/flash_attention.py:70",
}
SOURCES = {name: "src/repro_torch/kernels/csrc/" + (
    "flash_attention.cu" if name == "flash_attention_bhsd"
    else "flash_attention_tf32.cu" if name == "flash_attention_bhsd_tf32"
    else "lm_kernels.cu" if name == "ddot_gemm_quantized"
    else "dse_eval.cu") for name in REPLACES}
# Tolerances of the attention kernel against its plain version: the
# reference's own (tests/test_flash_attention.py), since exponentials and
# summation order differ.
FLASH_TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
# Logits of the card's LM path against the port's CPU path on the same
# reduced model: tests/test_torch_lm.py's LOGIT_ATOL (bf16 activations,
# f32 sums in another order).
LOGIT_ATOL = 0.03


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


def _bound_ms(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


#: Opcode classes counted in a kernel's SASS (`sass_counts`): shared,
#: global and constant-bank loads, conversions (I2F counts the divisions'
#: too), and the start of each software integer division (nvcc emits one
#: I2F.U32.RP per division).
SASS_CLASSES = {"LDS": ("LDS",), "LDG": ("LDG",), "LDC": ("LDC", "ULDC"),
                "I2F": ("I2F",), "F2I": ("F2I",),
                "div": ("I2F.U32.RP", "I2F.RP")}


def sass_counts(library, kernels):
    """{kernel instance: {"instr": n, class: n, ...}} of the SASS that
    `cuobjdump -sass` reads from a built library, for every function whose
    mangled name holds one of `kernels`; None where cuobjdump is missing."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)")
    counts, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            hit = next((k for k in kernels if k in fn), None)
            cur = None
            if hit is not None:
                inst = re.search(r"I((?:L[bi]\d+E)+)E", fn)
                args = (",".join(re.findall(r"L[bi](\d+)E", inst.group(1)))
                        if inst else "")
                cur = counts.setdefault(
                    hit + (f"<{args}>" if args else ""),
                    {"instr": 0, **{c: 0 for c in SASS_CLASSES}})
            continue
        m = op.search(line) if cur is not None else None
        if m is None or m.group(1) == "NOP":
            continue
        cur["instr"] += 1
        for c, prefixes in SASS_CLASSES.items():
            if any(m.group(1) == q or m.group(1).startswith(q + ".")
                   for q in prefixes):
                cur[c] += 1
    return counts


def dse_inputs(dev):
    """The DSE kernels' operands this script checks and times (and
    `tools/stage_dse.py` times stage by stage), on device `dev`: deit-b
    under the default constraints; the paper's 12^5 grid, and a block of
    2048 copies of the golden deit-b winner followed by 300 grid rows; the
    whole 24^5 product space (also as (5, 24^5) config columns) and one
    slab of it; bert-b's 24^5 frontier (the numpy engine's Pareto BnB, 166
    rows), the running front kernel 1 prices in that search. Needs `src`
    on sys.path."""
    from types import SimpleNamespace

    import numpy as np
    import torch
    from repro_torch.core import (Constraints, FactorizedSpace, config_grid,
                                  search)
    from repro_torch.core.factorized import slab_bounding_span
    from repro_torch.core.paper_workloads import PAPER_WORKLOADS, load
    from repro_torch.core.performance_model import workload_statics
    from repro_torch.core.photonic_model import CONSTANTS
    from repro_torch.kernels import dse_eval as dse
    from repro_torch.kernels import ops

    def cols_of(rows):
        return torch.from_numpy(rows.T.astype("float32")).contiguous().to(dev)

    def ones(n):
        return torch.ones((1, n), dtype=torch.float32, device=dev)

    cons = Constraints()
    wl = load("deit-b")
    gemms, wl_scalars = workload_statics(wl, CONSTANTS)
    # The five paper workloads of one batched launch (search_workloads)
    workloads5 = tuple(workload_statics(load(n), CONSTANTS)
                       for n in sorted(PAPER_WORKLOADS))
    golden = json.loads(
        (ROOT / "tests" / "golden" / "dse_12x5.json").read_text())
    inc12 = list(range(1, 13))
    grid12 = config_grid(inc12, inc12, inc12, inc12, inc12)
    dup = np.concatenate([np.tile(
        np.asarray(golden["workloads"]["deit-b"]["best"]), (dse.BLOCK, 1)),
        grid12[:300]])
    space24 = FactorizedSpace.full(24)
    axes, radices = ops._axes_operand(space24, dev)
    slab = ((0, 3), (0, 4), (4, 20), (2, 18), (8, 16))
    b0, b1 = slab_bounding_span(radices, slab)
    meta = torch.from_numpy(
        ops._meta_rows(radices, [0], space24.size)[0]).to(dev)
    cols24 = torch.stack(dse._decode_block_plain(radices, axes, meta, 1,
                                                 space24.size)[0])
    # The running front the Pareto BnB prices between frontier launches
    # (`search._cuda_front_points`): bert-b's 24^5 frontier, 166 rows.
    wl_front = load("bert-b")
    front = search(wl_front, cons, engine="numpy", factorized=True,
                   space=space24, prune="bound", objective="pareto",
                   device=dev).front
    gemms_f, wl_scalars_f = workload_statics(wl_front, CONSTANTS)
    cons_row = torch.tensor([[cons.area_mm2, cons.power_w, cons.energy_j,
                              cons.latency_s]], dtype=torch.float32,
                            device=dev)
    return SimpleNamespace(
        cons=cons, cons_row=cons_row,
        carry=torch.full((1, 1), float("inf"), dtype=torch.float32,
                         device=dev),
        wl=wl, gemms=gemms, wl_scalars=wl_scalars,
        workloads=((gemms, wl_scalars),), golden=golden,
        workloads5=workloads5,
        cons5=cons_row.repeat(len(workloads5), 1).contiguous(),
        carry5=torch.full((len(workloads5), 1), float("inf"),
                          dtype=torch.float32, device=dev),
        grid12=grid12, cols=cols_of(grid12), mask=ones(len(grid12)),
        dup=dup, cols_dup=cols_of(dup), mask_dup=ones(len(dup)),
        space24=space24, axes=axes, radices=radices, n24=space24.size,
        cols24=cols24, wl_front=wl_front, front=front,
        cols_front=cols_of(front), gemms_front=gemms_f,
        wl_scalars_front=wl_scalars_f,
        meta=meta,
        slab=slab, b0=b0, b1=b1,
        meta_s=torch.from_numpy(
            ops._meta_rows(radices, [b0], b1, slab)[0]).to(dev))


def service_phase(dev, n_z, hw, drive_service, float32_ties):
    """Phase 4c: the resident DSE service on the card (`repro_torch.serve`).

    `SearchService(engine="cuda")` over the n_z^5 space answers the five
    paper workloads cold under the paper box (min-EDP), two tightened boxes
    per workload warm, a repeat from the memo and one submit/drain batch of
    the five under a looser box (cold, one batched call); deit-b and bert-b
    cold then warm in Pareto mode; a robust node45 worst-case query; then
    the resilient runtime on the card (a service checkpoint root resumed by
    a restarted service, a BnB killed at a checkpoint and resumed, an
    injected launch failure retried; launch failures past the retries and
    an injected NaN block, each of which must fail the search with
    LaunchExhausted or NanDetected, since on a card the runtime falls back
    to no other engine and re-prices nothing on the host) and the `dse`
    launcher in-process.

    Every answer (winner and float64 metrics, or frontier) equals the numpy
    engine's `search(..., factorized=True, prune="bound")` under the same
    box and a numpy-engine service's answer to the same query, and so do
    its BnB counters — except `n_feasible` where a config sits within a
    float32 ulp of a bound of the box, which the float32 engines classify
    as the kernels compute it (the documented caveat of `search`; it also
    separates a cold cuda search from numpy's). So every counter must also
    equal a torch-engine service's (the same float32 cost model, in plain
    torch), and the services' `stats` must be equal. `drive_service(label,
    fn, needs)` runs one entry-point call with the launch counts set to 0
    just before it, fails unless each kernel in `needs` launched, adds the
    counts to the "service" path and returns (result, wall seconds,
    counts); `float32_ties(got, want, wl)` is phase 4's frontier rule. `hw`
    is the card's name and power limit."""
    import tempfile

    import numpy as np
    from repro_torch.core import (Constraints, FactorizedSpace,
                                  RuntimePolicy, SearchRuntime, search)
    from repro_torch.core.calibration import load_calibration_preset
    from repro_torch.core.paper_workloads import PAPER_WORKLOADS, load
    from repro_torch.core.runtime import (KillSearch, LaunchExhausted,
                                          NanDetected)
    from repro_torch.launch import serve as launch
    from repro_torch.serve import SearchService
    from repro_torch.testing import FaultSpec, inject

    space = FactorizedSpace.full(n_z)
    names = sorted(PAPER_WORKLOADS)
    wls = {n: load(n) for n in names}
    edp_search = ("dse_search_decoded", "dse_search_padded")
    pareto_search = ("dse_pareto_decoded", "dse_pareto_padded",
                     "dse_eval_padded")
    work = ("n_evaluated", "n_feasible", "n_workload_evals", "n_pruned",
            "n_bounds")
    work64 = tuple(k for k in work if k != "n_feasible")
    health = ("n_retries", "n_fallbacks", "n_quarantined")

    def numpy_search(wl, cons, **kw):
        return search(wl, cons, engine="numpy", factorized=True, space=space,
                      prune="bound", device=dev, **kw)

    def same_edp(got, want, keys=()):
        return ((got.best_cfg, got.edp, got.area_mm2, got.power_w,
                 got.energy_j, got.latency_s)
                == (want.best_cfg, want.edp, want.area_mm2, want.power_w,
                    want.energy_j, want.latency_s)
                and all(getattr(got, k) == getattr(want, k) for k in keys))

    def same_counts(got, want, keys):
        return all(getattr(got, k) == getattr(want, k) for k in keys)

    def healthy(r, label):
        _check(all(getattr(r, k) == 0 for k in health),
               f"service {label}: no fault was injected, yet "
               f"{[(k, getattr(r, k)) for k in health]}")

    svc = SearchService(space=space, engine="cuda", device=dev)
    ref_svc = SearchService(space=space, engine="numpy", device=dev)
    f32_svc = SearchService(space=space, engine="torch", device=dev)
    walls = []

    def check(label, kind, got, want, want32, twin, wl):
        """One answer against numpy's search (`twin`) and the numpy and
        torch services' answers to the same query."""
        edges = [r.n_feasible for r in ((want, twin) if kind == "cold"
                                        else (want,))
                 if r.n_feasible != got.n_feasible]
        if hasattr(got, "front"):
            for ref_front in (want, twin):
                held = float32_ties(got, ref_front, wl)
                _check(np.array_equal(got.front, ref_front.front[held])
                       and all(np.array_equal(got.metrics[k],
                                              ref_front.metrics[k][held])
                               for k in ref_front.metrics),
                       f"service {label} {kind}: frontier differs from "
                       f"the numpy engine's")
            answer = f"{got.size} frontier rows (numpy {twin.size})"
        else:
            _check(same_edp(got, twin) and same_edp(got, want)
                   and same_edp(got, want32),
                   f"service {label} {kind}: {got.best_cfg} {got.edp!r} vs "
                   f"numpy {twin.best_cfg} {twin.edp!r}")
            answer = f"{got.best_cfg} edp {got.edp!r}"
        _check(same_counts(got, want32, work)
               and same_counts(got, want, work64)
               and (kind != "cold" or same_counts(got, twin, work64)),
               f"service {label} {kind}: counters "
               f"{[getattr(got, k) for k in work]}, numpy service "
               f"{[getattr(want, k) for k in work]}, torch service "
               f"{[getattr(want32, k) for k in work]}")
        print(f"service {label}: {answer}; counters equal the numpy and "
              f"torch services'"
              + (f" (numpy n_feasible {edges[0]} against {got.n_feasible}: "
                 f"configs within a float32 ulp of a bound)" if edges
                 else ""))

    def ask(label, kind, wl, box, objective="edp", needs=()):
        got, wall, counts = drive_service(
            f"{label} ({kind})",
            lambda: svc.query(wl, box, objective=objective), needs)
        walls.append((label, kind, wall))
        healthy(got, label)
        print(f"service {label}: {kind} {wall:.4f} s ({hw}); launches "
              f"{ {k: n for k, n in counts.items() if n} }")
        want = ref_svc.query(wl, box, objective=objective)
        want32 = f32_svc.query(wl, box, objective=objective)
        check(label, kind, got, want, want32,
              numpy_search(wl, box, objective=objective), wl)
        return got, want

    def same_stats():
        _check(svc.stats == ref_svc.stats == f32_svc.stats,
               f"service stats {svc.stats} differ from the numpy "
               f"service's {ref_svc.stats} or the torch service's "
               f"{f32_svc.stats}")

    # -- min-EDP: cold, warm, memo, batched --------------------------------
    cold_box = Constraints()
    boxes = (Constraints(power_w=4.5),
             Constraints(power_w=4.0, area_mm2=45.0))
    for n in names:
        ask(f"{n} paper box", "cold", wls[n], cold_box, needs=edp_search)
    for n in names:
        for box in boxes:
            label = (f"{n} power_w={box.power_w:g}"
                     + (f" area_mm2={box.area_mm2:g}"
                        if box.area_mm2 != cold_box.area_mm2 else ""))
            ask(label, "warm", wls[n], box)
    before = dict(svc.stats)
    got, want = ask("deit-b paper box again", "memo", wls["deit-b"],
                    cold_box)
    _check(svc.stats["memo_hits"] == before["memo_hits"] + 1
           and got is svc.query(wls["deit-b"], cold_box)
           and ref_svc.query(wls["deit-b"], cold_box) is want
           and f32_svc.query(wls["deit-b"], cold_box) is not None,
           "service memo: the repeat was not answered from the memo")
    loose = Constraints(power_w=6.0)
    for s_ in (svc, ref_svc, f32_svc):
        for n in names:
            s_.submit(wls[n], loose)
    batch, wall, counts = drive_service("drain of 5 under power_w=6",
                                        svc.drain, edp_search)
    walls.append(("5 workloads power_w=6 (submit/drain)", "cold batch",
                  wall))
    print(f"service drain of 5 under power_w=6: cold batch {wall:.4f} s "
          f"({hw}); launches { {k: n for k, n in counts.items() if n} }")
    for n, got, want, want32 in zip(names, batch, ref_svc.drain(),
                                    f32_svc.drain()):
        healthy(got, f"{n} power_w=6")
        check(f"{n} power_w=6 (drain)", "cold", got, want, want32,
              numpy_search(wls[n], loose), wls[n])
    same_stats()
    _check((svc.stats["cold"], svc.stats["warm"], svc.stats["memo_hits"],
            svc.stats["batched_calls"]) == (10, 10, 2, 1),
           f"service stats {svc.stats}")
    print(f"service min-EDP: stats equal the numpy and torch services' "
          f"({svc.stats})")

    # -- Pareto: cold then warm --------------------------------------------
    for n in ("deit-b", "bert-b"):
        ask(f"{n} pareto paper box", "cold", wls[n], cold_box,
            objective="pareto", needs=pareto_search)
        ask(f"{n} pareto power_w=4.5", "warm", wls[n],
            Constraints(power_w=4.5), objective="pareto")
    same_stats()

    # -- robust: node45 worst case, cold on cuda ---------------------------
    node45 = load_calibration_preset("node45")
    robust = dict(calibration=node45, robust="worst_case")
    rsvc = SearchService(space=space, engine="cuda", device=dev, **robust)
    got, wall, counts = drive_service(
        "deit-b robust node45", lambda: rsvc.query(wls["deit-b"], cold_box),
        edp_search)
    walls.append(("deit-b robust node45 paper box", "cold", wall))
    healthy(got, "robust")
    want = numpy_search(wls["deit-b"], cold_box, **robust)
    want32 = SearchService(space=space, engine="torch", device=dev,
                           **robust).query(wls["deit-b"], cold_box)
    plain = numpy_search(wls["deit-b"], cold_box)
    # (infeasible under the worst corner below 24^5: no band on either)
    band_ok = (got.band is None) == (want.band is None) and (
        want.band is None
        or all(getattr(got.band, side)[k] == getattr(want.band, side)[k]
               for side in ("worst", "nominal", "best")
               for k in want.band.worst))
    _check(same_edp(got, want, work64) and same_counts(got, want32, work)
           and band_ok,
           f"service robust: {got.best_cfg} {got.edp!r} vs numpy "
           f"{want.best_cfg} {want.edp!r} (band equal: {band_ok})")
    band = ("no band (infeasible)" if got.band is None else
            f"band edp [{got.band.best['edp']!r}, "
            f"{got.band.worst['edp']!r}]")
    print(f"service deit-b robust node45 worst case: cold {wall:.4f} s "
          f"({hw}); {got.best_cfg} edp {got.edp!r} (nominal winner "
          f"{plain.best_cfg}), {band}, equal numpy's; launches "
          f"{ {k: n for k, n in counts.items() if n} }")

    # -- the resilient runtime on the card ---------------------------------
    wl = wls["deit-b"]
    ref = numpy_search(wl, cold_box)
    with tempfile.TemporaryDirectory() as root:
        first = SearchService(space=space, engine="cuda", device=dev,
                              checkpoint_root=root)
        r1, wall, _ = drive_service(
            "deit-b under a checkpoint root",
            lambda: first.query(wl, cold_box), edp_search)
        healthy(r1, "checkpointed")
        again = SearchService(space=space, engine="cuda", device=dev,
                              checkpoint_root=root)
        r2, wall2, _ = drive_service(
            "deit-b restarted service", lambda: again.query(wl, cold_box),
            ())
        _check(same_edp(r1, ref, work) and same_edp(r2, ref, work)
               and r1.n_checkpoints > 0 and r2.resumed_step > 0,
               f"service checkpoint root: {r1.n_checkpoints} checkpoints, "
               f"resumed at {r2.resumed_step}, answers equal numpy: "
               f"{same_edp(r1, ref, work)}, {same_edp(r2, ref, work)}")
        print(f"service checkpoint root: cold {wall:.4f} s with "
              f"{r1.n_checkpoints} checkpoints; a restarted service resumed "
              f"at unit {r2.resumed_step} in {wall2:.4f} s ({hw}), same "
              f"answer")

        def bnb(rt):
            return search(wl, cold_box, engine="cuda", factorized=True,
                          space=space, prune="bound", device=dev, runtime=rt)

        clean = bnb(SearchRuntime(RuntimePolicy(
            checkpoint_dir=f"{root}/clean", sleep=lambda s: None)))
        healthy(clean, "uninterrupted runtime")
        killed_at = max(0, clean.n_checkpoints - 2)
        pol = RuntimePolicy(checkpoint_dir=f"{root}/killed",
                            sleep=lambda s: None)
        rt = SearchRuntime(pol)
        killed = False
        with inject(rt, [FaultSpec("checkpoint", "kill", at=killed_at)]):
            try:
                bnb(rt)
            except KillSearch:  # the fault this phase injected
                killed = True
        resumed = bnb(SearchRuntime(pol))
        _check(killed and resumed.resumed_step == killed_at + 1
               and same_edp(resumed, clean,
                            work + health + ("n_checkpoints",))
               and same_edp(clean, ref, work),
               f"kill/resume: killed {killed}, resumed at "
               f"{resumed.resumed_step}, byte-identical "
               f"{same_edp(resumed, clean, work)}")
        print(f"runtime: {n_z}^5 BnB killed at checkpoint {killed_at} of "
              f"{clean.n_checkpoints}, resumed at unit "
              f"{resumed.resumed_step}, winner and every counter equal the "
              f"uninterrupted run")

    def faulty(specs):
        rt = SearchRuntime(RuntimePolicy(sleep=lambda s: None))
        with inject(rt, specs):
            return search(wl, cold_box, engine="cuda", factorized=True,
                          space=space, prune="bound", device=dev, runtime=rt)

    got = faulty([FaultSpec("launch", "raise", at=0)])
    have = tuple(getattr(got, k) for k in health)
    _check(have == (1, 0, 0) and same_edp(got, ref, work),
           f"runtime, one injected launch failure: counters {have}, want "
           f"(1, 0, 0); answer equal {same_edp(got, ref, work)}")
    print(f"runtime: injected [('raise', 0)] -> n_retries/n_fallbacks/"
          f"n_quarantined {have}, same answer")
    for specs, fault, on_cpu in (
            ([FaultSpec("launch", "raise", at=i) for i in range(3)],
             LaunchExhausted, (3, 1, 0)),
            ([FaultSpec("launch", "nan", at=0)], NanDetected, (0, 0, 1))):
        label = [(s_.kind, s_.at) for s_ in specs]
        if dev.type == "cpu":  # a rehearsal: the reference's chain holds
            got = faulty(specs)
            have = tuple(getattr(got, k) for k in health)
            _check(have == on_cpu and same_edp(got, ref, work),
                   f"runtime {label} on the cpu: counters {have}")
            continue
        try:
            faulty(specs)
            failed = None
        except fault as e:  # the failure this phase injected
            failed = e
        _check(failed is not None, f"runtime {label}: the search answered; "
                                   f"on the card it must raise "
                                   f"{fault.__name__}")
        print(f"runtime: injected {label} -> {fault.__name__} ({failed}); "
              f"no fallback, no host re-pricing")

    # -- the dse launcher, in-process --------------------------------------
    _, wall, counts = drive_service(
        "launch.serve dse", lambda: launch.main(
            ["dse", "--workload", "all", "--n-z", str(n_z), "--device",
             str(dev), "--scenario", "power_w=4.5", "--scenario",
             "power_w=4.5"]), edp_search)
    print(f"launch.serve dse (5 workloads x 3 boxes): {wall:.4f} s ({hw})")
    return walls


#: The C entry point of each DSE kernel in `csrc/dse_eval.cu`.
DSE_ENTRIES = {"dse_eval_launch": "dse_eval_padded",
               "dse_search_padded_launch": "dse_search_padded",
               "dse_search_decoded_launch": "dse_search_decoded",
               "dse_decode_rows_launch": "dse_decode_rows",
               "dse_pareto_padded_launch": "dse_pareto_padded",
               "dse_pareto_decoded_launch": "dse_pareto_decoded"}


class LaunchesByThread:
    """A second count of the DSE launches, beside the wrappers' locked
    `LAUNCHES`: while active, each C entry point of the loaded `dse_eval`
    library is wrapped to append the kernel's name to a list of the
    calling thread's own (no shared read-modify-write). Phase 4e holds the
    two counts equal with four worker threads launching."""

    def __init__(self, lib):
        self.lib = lib
        self.by_thread = {}
        self._real = {}

    def __enter__(self):
        import threading

        for entry, kernel in DSE_ENTRIES.items():
            real = getattr(self.lib, entry)
            self._real[entry] = real

            def counted(*args, _real=real, _kernel=kernel):
                mine = self.by_thread.setdefault(threading.get_ident(), [])
                mine.append(_kernel)
                return _real(*args)

            setattr(self.lib, entry, counted)
        return self

    def __exit__(self, *exc):
        for entry, real in self._real.items():
            setattr(self.lib, entry, real)
        return False

    def reset(self):
        self.by_thread = {}

    def totals(self):
        out = {k: 0 for k in DSE_ENTRIES.values()}
        for names in self.by_thread.values():
            for name in names:
                out[name] += 1
        return out

    def threads(self):
        return sum(1 for names in self.by_thread.values() if names)


def scenario_phase(dev, n_z, hw, drive, float32_ties):
    """Phase 4d: the model-zoo scenario sweep (`repro_torch.scenarios`).

    `ScenarioGrid.zoo(kinds=("train", "prefill", "decode"), seq_lens=
    (2048,), batches=(8,), new_tokens=(16, 64))` — all 10 archs at their
    published configs, 40 scenarios — is swept through one cuda
    `SearchService` on the n_z^5 space under per-class boxes (decode
    latency_ms=2, the paper box otherwise), twice: the second sweep must be
    40 memo hits with no launch. At these widths every scenario is
    infeasible under those boxes (the bounds prune the whole space), so the
    grid is swept a third time under the area/power box alone (energy and
    latency unbounded), where the decode scenarios are feasible and the
    search kernels run. Every winner (config and float64 metrics) equals a
    numpy-engine service's sweep of the same grid, and every counter a
    torch-engine service's (numpy's too, except `n_feasible` at the
    float32 edge, phase 4c's rule). Then a Pareto sweep of the launcher's
    3-arch subset of the grid under the area/power box (frontiers held to
    numpy's with phase 4's float32-edge rule) and `launch.serve scenarios`
    with its defaults. `drive(label, fn, needs)` is phase 4c's, counting
    under the path "scenarios". Returns the phase's wall times."""
    import numpy as np
    from repro_torch.core import Constraints, FactorizedSpace
    from repro_torch.launch import serve as launch
    from repro_torch.scenarios import ScenarioGrid, sweep
    from repro_torch.serve import SearchService

    space = FactorizedSpace.full(n_z)
    shape = dict(kinds=("train", "prefill", "decode"), seq_lens=(2048,),
                 batches=(8,), new_tokens=(16, 64))
    grid = ScenarioGrid.zoo(**shape)
    boxes = {"decode": Constraints(latency_ms=2)}
    area_power = Constraints(energy_mj=math.inf, latency_ms=math.inf)
    work = ("n_evaluated", "n_feasible", "n_workload_evals", "n_pruned",
            "n_bounds")
    work64 = tuple(k for k in work if k != "n_feasible")
    health = ("n_retries", "n_fallbacks", "n_quarantined")
    walls = []

    def counts_equal(got, want, keys):
        return all(getattr(got, k) == getattr(want, k) for k in keys)

    def same_edp(got, want):
        return ((got.best_cfg, got.edp, got.area_mm2, got.power_w,
                 got.energy_j, got.latency_s)
                == (want.best_cfg, want.edp, want.area_mm2, want.power_w,
                    want.energy_j, want.latency_s))

    def run(label, svc, objective, g, box, needs=()):
        rep, wall, counts = drive(
            label, lambda: sweep(g, box, service=svc, objective=objective),
            needs)
        walls.append((label, wall))
        print(f"scenarios {label}: {len(rep.results)} scenarios in "
              f"{wall:.4f} s ({hw}); stats delta {rep.stats}; launches "
              f"{ {k: n for k, n in counts.items() if n} }")
        return rep, counts

    svc, ref_svc, f32_svc = (SearchService(space=space, engine=e, device=dev)
                             for e in ("cuda", "numpy", "torch"))

    def held_to_numpy(label, rep, box):
        """Every winner against the numpy and torch services' sweeps of
        the same grid under the same boxes; returns the feasible count."""
        want = sweep(grid, box, service=ref_svc)
        want32 = sweep(grid, box, service=f32_svc)
        _check(len(rep.results) == 40,
               f"{label}: {len(rep.results)} scenarios")
        edges = []
        for got, ref, ref32 in zip(rep.results, want.results,
                                   want32.results):
            g, w, w32 = got.result, ref.result, ref32.result
            _check(got.scenario.name == ref.scenario.name
                   and same_edp(g, w) and same_edp(g, w32)
                   and counts_equal(g, w32, work)
                   and counts_equal(g, w, work64)
                   and all(getattr(g, k) == 0 for k in health),
                   f"{label} {got.scenario.name}: {g.best_cfg} {g.edp!r} "
                   f"{[getattr(g, k) for k in work]} vs numpy {w.best_cfg} "
                   f"{w.edp!r} {[getattr(w, k) for k in work]}")
            if g.n_feasible != w.n_feasible:
                edges.append((got.scenario.name, w.n_feasible, g.n_feasible))
        _check(rep.stats == want.stats == want32.stats,
               f"{label} stats {rep.stats}, numpy {want.stats}, torch "
               f"{want32.stats}")
        _check(rep.format() == want.format(),
               f"{label}: the report differs from the numpy service's")
        n_feasible = sum(r.result.feasible for r in rep.results)
        print(f"scenarios {label}: 40 winners equal the numpy service's "
              f"({n_feasible} feasible), counters the torch service's"
              + (f"; numpy n_feasible differs at the float32 edge: {edges}"
                 if edges else ""))
        return n_feasible

    rep, _ = run("zoo sweep 1 (cold, edp)", svc, "edp", grid, boxes)
    _check(rep.stats["cold"] == 40, f"zoo sweep 1: stats {rep.stats}")
    held_to_numpy("zoo sweep 1", rep, boxes)
    again, counts = run("zoo sweep 2 (memo)", svc, "edp", grid, boxes)
    _check(again.stats["memo_hits"] == 40 and again.stats["cold"] == 0
           and sum(counts.values()) == 0
           and all(a.result is b.result
                   for a, b in zip(rep.results, again.results)),
           f"zoo sweep 2: stats {again.stats}, launches {counts}")
    rep, counts = run("zoo sweep 3 (cold, edp, area/power box)", svc, "edp",
                      grid, area_power)
    n_feasible = held_to_numpy("zoo sweep 3", rep, area_power)
    _check(n_feasible > 0 and counts["dse_search_decoded"] > 0,
           f"zoo sweep 3: {n_feasible} feasible scenarios, kernel 3 "
           f"launched {counts['dse_search_decoded']} times")
    print(rep.format())

    subset = ScenarioGrid(models=("qwen2.5-3b", "rwkv6-7b", "olmoe-1b-7b"),
                          **shape)
    prep, counts = run("3-arch sweep (cold, pareto, area/power box)", svc,
                       "pareto", subset, area_power, ("dse_pareto_decoded",))
    pwant = sweep(subset, area_power, service=ref_svc, objective="pareto")
    for got, ref in zip(prep.results, pwant.results):
        g, w = got.result, ref.result
        held = float32_ties(g, w, got.workload)
        _check(np.array_equal(g.front, w.front[held])
               and all(np.array_equal(g.metrics[k], w.metrics[k][held])
                       for k in w.metrics)
               and counts_equal(g, w, work64),
               f"pareto sweep {got.scenario.name}: {g.size} frontier rows "
               f"vs numpy {w.size}")
    print("scenarios pareto sweep: " + ", ".join(
        f"{r.scenario.name} {r.result.size}" for r in prep.results)
        + " frontier rows, equal the numpy service's")

    _, wall, counts = drive("launch.serve scenarios (defaults)",
                            lambda: launch.main(["scenarios"]), ())
    walls.append(("launch.serve scenarios (defaults, 2 sweeps)", wall))
    print(f"launch.serve scenarios (defaults): {wall:.4f} s ({hw}); "
          f"launches { {k: n for k, n in counts.items() if n} }")
    return walls


def workers_phase(dev, n_z, hw, drive, float32_ties, by_thread):
    """Phase 4e: the parallel slab scheduler (`search(..., workers=N)`).

    The five paper workloads on the n_z^5 space, `factorized=True,
    prune="bound"`, both objectives: `workers=None`, `workers=1`,
    `workers=4` (deterministic) and `workers=4, deterministic=False`, all
    on the cuda engine. Winners, frontiers and `canonical_counters` of
    `workers=1` and `workers=4` equal `workers=None`'s; a frontier may
    differ only by a row at the float32 edge (phase 4's rule against the
    numpy engine: a split batch puts two configs that tie in float32 into
    different launches). The async mode keeps the winner and frontier
    under the same rule and covers the space. Then one fault of each kind
    ("kill", "raise", "timeout") at "lease", a checkpointed `workers=4`
    query killed and resumed under `workers=1`, and a `SearchService(
    workers=4)` cold query and warm delta equal to the `workers=None`
    service's. Every call's launch counts (`LAUNCHES`, locked) equal a
    second count kept per thread (`by_thread`). `drive` counts under the
    path "workers". Returns the phase's wall times."""
    import tempfile

    import numpy as np
    from repro_torch.core import (Constraints, FactorizedSpace,
                                  RuntimePolicy, SearchRuntime, search)
    from repro_torch.core.paper_workloads import PAPER_WORKLOADS, load
    from repro_torch.core.runtime import KillSearch
    from repro_torch.parallel import canonical_counters
    from repro_torch.serve import SearchService
    from repro_torch.testing import FaultSpec, inject

    space = FactorizedSpace.full(n_z)
    names = sorted(PAPER_WORKLOADS)
    wls = {n: load(n) for n in names}
    cons = Constraints()
    walls = []
    needs = {"edp": ("dse_search_decoded",),
             "pareto": ("dse_pareto_decoded", "dse_eval_padded")}

    def query(wl, objective, **kw):
        return search(wl, cons, engine="cuda", factorized=True,
                      space=space, prune="bound", objective=objective,
                      device=dev, **kw)

    def drive_counted(label, fn, needs_):
        """`drive`, with the launches counted a second way per thread."""
        by_thread.reset()
        out, wall, counts = drive(label, fn, needs_)
        dse = {k: n for k, n in counts.items() if k in DSE_ENTRIES.values()}
        _check(dse == by_thread.totals(),
               f"workers {label}: LAUNCHES {dse} differ from the per-thread "
               f"count {by_thread.totals()}")
        return out, wall, counts, by_thread.threads()

    def same_answer(got, want, wl, objective, label):
        """Exact, or (a frontier) at the float32 edge only."""
        if objective == "edp":
            _check(got.best_cfg == want.best_cfg and got.edp == want.edp,
                   f"workers {label}: {got.best_cfg} {got.edp!r} vs "
                   f"{want.best_cfg} {want.edp!r}")
            return "equal"
        if np.array_equal(got.front, want.front):
            return "equal"
        ref = query_numpy(wl)
        for r in (got, want):
            held = float32_ties(r, ref, wl)
            _check(np.array_equal(r.front, ref.front[held]),
                   f"workers {label}: frontier differs beyond the float32 "
                   f"edge")
        return (f"differs at the float32 edge ({got.size} rows against "
                f"{want.size}, numpy {ref.size})")

    def query_numpy(wl):
        return search(wl, cons, engine="numpy", factorized=True, space=space,
                      prune="bound", objective="pareto", device=dev)

    for objective in ("edp", "pareto"):
        for n in names:
            wl = wls[n]
            runs = {}
            for label, kw in (("None", {}), ("1", dict(workers=1)),
                              ("4", dict(workers=4)),
                              ("4 async", dict(workers=4,
                                               deterministic=False))):
                res, wall, counts, threads = drive_counted(
                    f"{objective} {n} workers={label}",
                    lambda: query(wl, objective, **kw), needs[objective])
                runs[label] = (res, wall, counts, threads)
            base = runs["None"][0]
            for label in ("1", "4", "4 async"):
                res = runs[label][0]
                how = same_answer(res, base, wl, objective,
                                  f"{objective} {n} workers={label}")
                if label != "4 async":
                    _check(canonical_counters(res)
                           == canonical_counters(base),
                           f"workers {objective} {n} workers={label}: "
                           f"{canonical_counters(res)} vs "
                           f"{canonical_counters(base)}")
                _check(res.n_pruned + res.n_workload_evals == space.size,
                       f"workers {objective} {n} workers={label}: coverage")
                runs[label] += (how,)
            walls.append((f"{objective} {n}", {k: v[1]
                                                for k, v in runs.items()}))
            print(f"workers {objective} {n} ({hw}): " + "; ".join(
                f"workers={k} {v[1]:.4f} s, launches "
                f"{ {c: m for c, m in v[2].items() if m} } from "
                f"{v[3]} thread(s)" for k, v in runs.items()))
            print(f"workers {objective} {n}: answers "
                  + ", ".join(f"workers={k} {v[4]}"
                              for k, v in runs.items() if k != "None")
                  + f"; canonical counters equal; workers=4 sched "
                  f"{runs['4'][0].sched}; async sched "
                  f"{runs['4 async'][0].sched}")

    # -- faults at the lease, one of each kind -------------------------------
    wl = wls["deit-b"]
    base = query(wl, "edp")
    for kind in ("kill", "raise", "timeout"):
        rt = SearchRuntime(RuntimePolicy(sleep=lambda s: None))
        with inject(rt, [FaultSpec("lease", kind, at=0)]) as inj:
            got, wall, counts, _ = drive_counted(
                f"fault {kind} at lease", lambda: query(
                    wl, "edp", workers=4, runtime=rt), ())
        _check(("lease", kind, 0) in inj.hits
               and got.best_cfg == base.best_cfg and got.edp == base.edp
               and canonical_counters(got) == canonical_counters(base)
               and got.sched.n_requeued >= 1,
               f"workers fault {kind}: {got.best_cfg} {got.sched}")
        print(f"workers fault {kind} at lease: same answer and counters, "
              f"{wall:.4f} s; {got.sched}")

    # -- a checkpointed workers=4 query killed, resumed under workers=1 -----
    with tempfile.TemporaryDirectory() as root:
        pol = RuntimePolicy(checkpoint_dir=root, sleep=lambda s: None)
        rt = SearchRuntime(pol)
        killed = False
        with inject(rt, [FaultSpec("checkpoint", "kill", at=1)]):
            try:
                query(wl, "edp", workers=4, runtime=rt)
            except KillSearch:  # the fault this phase injected
                killed = True
        got, wall, _, _ = drive_counted(
            "resume under workers=1", lambda: query(
                wl, "edp", workers=1, runtime=SearchRuntime(pol)), ())
        _check(killed and got.resumed_step > 0
               and got.best_cfg == base.best_cfg and got.edp == base.edp
               and canonical_counters(got) == canonical_counters(base),
               f"workers kill/resume: killed {killed}, resumed at "
               f"{got.resumed_step}, {got.best_cfg}")
        print(f"workers: a workers=4 query killed at checkpoint 1 resumed "
              f"under workers=1 at unit {got.resumed_step} in {wall:.4f} s, "
              f"same answer and counters")

    # -- the service with workers=4 ------------------------------------------
    one = SearchService(space=space, engine="cuda", device=dev)
    par = SearchService(space=space, engine="cuda", device=dev, workers=4)
    for label, box in (("cold", cons), ("warm", Constraints(power_w=4.5))):
        want = one.query(wl, box)
        got, wall, counts, threads = drive_counted(
            f"service workers=4 {label}", lambda: par.query(wl, box),
            ("dse_search_decoded",) if label == "cold" else ())
        _check(got.best_cfg == want.best_cfg and got.edp == want.edp
               and canonical_counters(got) == canonical_counters(want),
               f"workers service {label}: {got.best_cfg} vs "
               f"{want.best_cfg}")
        walls.append((f"service workers=4 {label}", wall))
        print(f"workers service {label}: {wall:.4f} s ({hw}), equal the "
              f"workers=None service; launches "
              f"{ {k: n for k, n in counts.items() if n} } from {threads} "
              f"thread(s)")
    _check(par.stats == one.stats, f"workers service stats {par.stats} vs "
                                   f"{one.stats}")
    return walls


#: Phase 6b's families: each whole at its published widths, deepseek-v3-671b
#: with its depth cut to this many layers (3 dense MLA layers, 1 MoE layer
#: of 256 experts, MTP depth 1). Widths are never cut.
FAMILY_ARCHS = ("olmoe-1b-7b", "zamba2-7b", "rwkv6-7b", "seamless-m4t-medium",
                "deepseek-v3-671b")
DEPTH_CUTS = {"deepseek-v3-671b": 4}
SRC_FRAMES = 64


def families_phase(dev, hw, drive, counters):
    """Phase 6b: serve each model family that phase 6 does not (moe,
    hybrid_ssm, rwkv, encdec, mla_moe) on the card at its published widths
    (random weights from a seeded generator), one model resident at a time.

    Per family: build; prefill 4 left-padded prompts (finite logits, every
    cache key in `init_cache`'s layout); serve 4 requests x 12 new tokens
    twice through `Server(batch_size=4, max_len=64)` (the enc-dec family,
    which `Server` cannot feed source frames, greedily through
    `models.prefill`/`decode_step` with 64 frames of `src_embeds`); score
    one (4, 16) batch with `forward` and `lm_loss` (finite; deepseek's
    `mtp_logits` too); hold the reduced same-family model on the card
    against the port's CPU path (prefill logits and one decode step within
    LOGIT_ATOL); price the published config with `photonic_report`. Every
    call runs under `drive(label, fn, needs=())`, and no hand-written
    kernel may launch (no reference model calls one). Returns the phase's
    rows: (arch, ttft_s per run, decode_s_per_tok per run, peak GiB,
    build s)."""
    import numpy as np
    import torch

    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.train.serve import (Request, Server, _grow_cache,
                                         photonic_report)

    def run(label, fn):
        out, wall = drive(label, fn, needs=())
        launched = {k: n for c in counters for k, n in c.items() if n}
        _check(not launched, f"{label}: launched {launched}; no reference "
                             f"model calls a kernel")
        return out, wall

    def batch_of(cfg, toks, gen):
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        if cfg.family == "encdec":
            batch["src_embeds"] = torch.randn(
                (toks.shape[0], SRC_FRAMES, cfg.d_model), generator=gen,
                device=dev)
        return batch

    def left_pad(prompts):
        plen = max(len(p_) for p_ in prompts)
        return np.stack([np.pad(p_, (plen - len(p_), 0)) for p_ in prompts])

    def greedy_encdec(params, cfg, batch, max_new):
        """`Server.generate`'s loop through models.prefill/decode_step."""
        plen = batch["tokens"].shape[1]
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = models.prefill(params, cfg, batch)
            cache = _grow_cache(cache, 64)
            torch.cuda.synchronize()
            ttft = time.perf_counter() - t0
            tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
            outs, steps = [tok[:, 0].tolist()], []
            for j in range(max_new - 1):
                t1 = time.perf_counter()
                logits, cache = models.decode_step(params, cfg, tok,
                                                   plen + j, cache)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t1)
                tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
                outs.append(tok[:, 0].tolist())
        return {"ttft_s": ttft, "decode_s_per_tok": float(np.mean(steps)),
                "out": [list(r) for r in zip(*outs)]}

    def serve_twice(arch, params, cfg, prompts, batch):
        """4 requests x 12 new tokens, twice: (ttft_s, decode_s_per_tok)
        per run. The server lives only here, so the family's weights go
        with the caller's `del`."""
        ttfts, decodes = [], []
        for run_name in ("first", "second"):
            if cfg.family == "encdec":
                stats, _ = run(f"greedy {arch} 4x12 ({run_name})",
                               lambda: greedy_encdec(params, cfg, batch, 12))
                outs = stats["out"]
            else:
                reqs = [Request(prompt=p_, max_new=12) for p_ in prompts]
                srv = Server(cfg, params, batch_size=4, max_len=64,
                             device=dev)
                stats, _ = run(f"serve {arch} 4x12 ({run_name})",
                               lambda: srv.generate(reqs))
                outs = [r.out for r in reqs]
                _check(stats["tokens"] == 48, f"{arch} serving: "
                       f"{stats['tokens']} tokens, not 48")
            _check(len(outs) == 4 and all(
                len(o) == 12 and all(0 <= t_ < cfg.vocab for t_ in o)
                for o in outs), f"{arch} serving: wrong number of tokens "
                                f"or ids")
            ttfts.append(stats["ttft_s"])
            decodes.append(stats["decode_s_per_tok"])
            print(f"serve {arch} ({run_name} call, {hw}): 48 tokens, ttft_s "
                  f"{stats['ttft_s']!r}, decode_s_per_tok "
                  f"{stats['decode_s_per_tok']!r}; request 0: {outs[0]}")
        return ttfts, decodes

    t_phase = time.perf_counter()
    base = torch.cuda.memory_allocated()
    rows = []
    for arch in FAMILY_ARCHS:
        published = get_config(arch)
        cfg = published
        if arch in DEPTH_CUTS:
            cfg = dataclasses.replace(cfg, n_layers=DEPTH_CUTS[arch])
            print(f"{arch}: depth cut {published.n_layers} -> {cfg.n_layers} "
                  f"layers ({cfg.moe.first_dense_layers} dense, "
                  f"{cfg.n_layers - cfg.moe.first_dense_layers} MoE of "
                  f"{cfg.moe.n_experts} experts, MTP depth {cfg.mtp_depth});"
                  f" widths as published")
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)

        # the reduced same-family model: the card against the CPU path
        small = reduced(published)
        small_cpu = models.init_params(small, torch.Generator().manual_seed(1),
                                       "cpu")
        small_dev = models.init_params(small, torch.Generator().manual_seed(1),
                                       "cpu").to(dev)
        rng = np.random.default_rng(1)
        toks = rng.integers(1, small.vocab, size=(4, 10)).astype(np.int32)
        src = rng.standard_normal((4, 8, small.d_model)).astype(np.float32)
        with torch.inference_mode():
            runs = []   # (model, device, prefill logits, cache)
            for model, d in ((small_cpu, torch.device("cpu")),
                             (small_dev, dev)):
                b = {"tokens": torch.from_numpy(toks).to(d)}
                if small.family == "encdec":
                    b["src_embeds"] = torch.from_numpy(src).to(d)
                logits, cache = models.prefill(model, small, b)
                runs.append((model, d, logits, _grow_cache(cache, 12)))
            # one decode step of the CPU path's greedy token on both
            tok = torch.argmax(runs[0][2], -1).to(torch.int32)[:, None]
            steps = [models.decode_step(model, small, tok.to(d), 10,
                                        cache)[0].cpu()
                     for model, d, _, cache in runs]
        errs = []
        for what, got, want in (("prefill", runs[1][2].cpu(), runs[0][2]),
                                ("decode step", steps[1], steps[0])):
            err = float((got - want).abs().max())
            errs.append(err)
            _check(err <= LOGIT_ATOL, f"reduced {arch} {what} logits: card "
                   f"vs CPU path differ by {err!r} > {LOGIT_ATOL}")
        print(f"reduced {arch}: card within {errs[0]!r} (prefill) and "
              f"{errs[1]!r} (one decode step) of the CPU path")
        del small_cpu, small_dev

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = models.init_params(cfg, gen, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = sum(p_.numel() for p_ in params.parameters())
        n_bytes = sum(p_.numel() * p_.element_size()
                      for p_ in params.parameters())
        print(f"{arch} ({cfg.family}, {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}): {n_params} parameters, {n_bytes / 1e9:.2f} GB"
              f", built in {build_s:.2f} s ({hw})")

        prng = np.random.default_rng(0)
        prompts = [prng.integers(1, cfg.vocab, size=prng.integers(4, 12))
                   .astype(np.int32) for _ in range(4)]
        toks = left_pad(prompts)
        batch = batch_of(cfg, toks, gen)
        with torch.inference_mode():
            (logits, cache), _ = run(f"prefill {arch}",
                                     lambda: models.prefill(params, cfg,
                                                            batch))
            want = models.init_cache(cfg, 4, toks.shape[1],
                                     src_len=SRC_FRAMES, device=dev)
        _check(tuple(logits.shape) == (4, cfg.vocab)
               and bool(torch.isfinite(logits).all()),
               f"{arch} prefill: logits not finite or of shape "
               f"{tuple(logits.shape)}")
        _check({k: (tuple(v.shape), v.dtype) for k, v in cache.items()}
               == {k: (tuple(v.shape), v.dtype) for k, v in want.items()},
               f"{arch} prefill: cache layout differs from init_cache's")
        del logits, cache, want

        ttfts, decodes = serve_twice(arch, params, cfg, prompts, batch)
        score = batch_of(cfg, np.random.default_rng(2).integers(
            0, cfg.vocab, size=(4, 16)).astype(np.int32), gen)
        with torch.inference_mode():
            out, t_fwd = run(f"forward {arch} (4, 16)",
                             lambda: models.forward(params, cfg, score))
            (loss, _), t_loss = run(f"lm_loss {arch} (4, 16)",
                                    lambda: models.lm_loss(params, cfg,
                                                           score))
        _check(tuple(out["logits"].shape) == (4, 16, cfg.vocab)
               and bool(torch.isfinite(out["logits"]).all())
               and bool(torch.isfinite(loss)),
               f"{arch} forward/lm_loss: not finite")
        if cfg.mtp_depth:
            _check("mtp_logits" in out
                   and bool(torch.isfinite(out["mtp_logits"]).all()),
                   f"{arch} forward: no finite mtp_logits")
        print(f"score {arch} (4, 16) ({hw}): forward {t_fwd:.4f} s, lm_loss "
              f"{float(loss)!r} in {t_loss:.4f} s"
              + (", mtp_logits finite" if cfg.mtp_depth else ""))
        del out, loss, batch, score
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{arch} peak device memory: {peak:.2f} GiB")
        print(f"photonic_report {arch} (published config):",
              photonic_report(published, seq_len=64, batch=4, new_tokens=12,
                              device=dev))
        rows.append((arch, ttfts, decodes, peak, build_s))
        del params
        torch.cuda.empty_cache()
        left = (torch.cuda.memory_allocated() - base) / 2**30
        _check(left < 0.5, f"{arch}: {left:.2f} GiB still allocated after "
                           f"its release; one model is resident at a time")
    print(f"phase 6b wall time: {time.perf_counter() - t_phase:.1f} s ({hw})")
    return rows


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device is available; this script runs on the GPU")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        _fail(f"run from a checkout of the repository: {ROOT / 'src'} does "
              f"not hold the repro_torch package")
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import FactorizedSpace, search, search_workloads
    from repro_torch.core.factorized import slab_indices
    from repro_torch.core.paper_workloads import PAPER_WORKLOADS, load
    from repro_torch.core.performance_model import workload_statics
    from repro_torch.core.photonic_model import CONSTANTS
    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels import ddot_gemm as ddot
    from repro_torch.kernels import dse_eval as dse
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import (build_all, library_path,
                                            load_library)
    from repro_torch.kernels.flash_attention import LAUNCHES as FA_LAUNCHES
    from repro_torch.kernels.flash_attention import (
        flash_attention_bhsd, flash_attention_bhsd_plain, tf32_splits,
        wgmma_path)
    from repro_torch.kernels.ref import quantize4
    from repro_torch.train.serve import Request, Server, photonic_report
    counters = (dse.LAUNCHES, ddot.LAUNCHES, FA_LAUNCHES)

    smi = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    clock = subprocess.run(["nvidia-smi", "-i", "0",
                            "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dse_ops_per_s = n_sm * F32_LANES_PER_SM * float(clock.stdout) * 1e6
    print(f"DSE bound rate: {n_sm} SMs x {F32_LANES_PER_SM} lanes x "
          f"{clock.stdout.strip()} MHz (clocks.max.sm) = "
          f"{dse_ops_per_s:.4g} instructions/s")
    build_s = build_all()
    print("build: " + ", ".join(f"{n} {t:.1f} s" for n, t in build_s.items())
          + " (nvcc, sm_90a, one process per source, all started together)")
    for name in build_s:
        # ptxas's registers, spills and static shared memory of each kernel
        log = library_path(name).with_suffix(".log")
        for line in (log.read_text().splitlines() if log.exists() else ()):
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    # instruction mix of the two search kernels (cuobjdump, where present)
    for kernel, c in (sass_counts(library_path("dse_eval"), (
            "dse_search_decoded_kernel", "dse_search_padded_kernel"))
            or {}).items():
        print(f"sass {kernel}: " + ", ".join(f"{k} {v}"
                                              for k, v in c.items()))
    print(f"search kernels: {load_library('dse_eval').dse_search_split()} "
          f"CTAs (one cluster) per logical block")
    # dynamic shared memory the launchers opt into (ptxas reports static)
    tf32 = load_library("flash_attention_tf32")
    print("flash_attention_tf32 dynamic smem: " + ", ".join(
        f"D {d_} {tf32.flash_attention_tf32_smem_bytes(d_)} B"
        for d_ in (36, 80, 128, 256)))
    # The LM path multiplies in full float32 (the reference's f32 products):
    # TF32 must stay off.
    print(f"float32 matmul precision {torch.get_float32_matmul_precision()!r},"
          f" allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    _check(torch.get_float32_matmul_precision() == "highest"
           and not torch.backends.cuda.matmul.allow_tf32,
           "TF32 is on: the LM path's float32 products would round")

    names = sorted(PAPER_WORKLOADS)
    inp = dse_inputs(dev)
    cons, cons_row, carry = inp.cons, inp.cons_row, inp.carry
    wl, gemms, wl_scalars = inp.wl, inp.gemms, inp.wl_scalars
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

    def check_close(name, got, want, shape, tol):
        torch.cuda.synchronize()
        same_shape = got.shape == want.shape and got.dtype == want.dtype
        err = _max_abs_err(got, want) if same_shape else math.inf
        _check(same_shape and torch.allclose(got.float(), want.float(),
                                             rtol=tol, atol=tol),
               f"{name}: kernel output differs from its plain version past "
               f"rtol = atol = {tol} at {shape} (max abs err {err!r})")
        return err

    def measure(name, kernel, plain, n_bytes, n_ops, shape, plain_time,
                ops_per_s=None, tol=None, library=None):
        """Check one kernel run against its plain version (equal, or
        allclose at `tol`) and time both, and `library` (one PyTorch call
        computing the same function) where given; `n_ops` may be a
        function of the kernel's output (work that depends on the
        data)."""
        got = kernel()
        extra = {}
        if name.startswith("dse_pareto"):
            # workload 0's feasible count per block: the frontier stage's
            # work (blocks with none skip it, f rows sort)
            f = got[1]
            extra = {"blocks_with_feasible": int((f > 0).sum()),
                     "blocks": f.numel(), "max_feasible": int(f.max())}
        if tol is None:
            err = check_equal(name, got, plain(), shape)
        else:
            err = check_close(name, got, plain(), shape, tol)
        if callable(n_ops):
            n_ops = n_ops(got)
        ms, plain_ms = _time_ms(kernel), plain_time(plain)
        lib_ms = None if library is None else _time_ms(library)
        bound, bound_by = _bound_ms(n_bytes, n_ops,
                                    ops_per_s or dse_ops_per_s)
        print(f"{name} {shape}: "
              + ("equal to plain" if tol is None else f"within {tol} of plain")
              + f" (max abs err {err!r}); kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by}), "
              f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
              + ("" if not extra else
                 f"; {extra['blocks_with_feasible']} of {extra['blocks']} "
                 f"blocks with a feasible lane, largest f "
                 f"{extra['max_feasible']}"))
        return got, {"shape": shape, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": lib_ms, **extra}

    def record(name, kernel, plain, n_bytes, n_ops, shape,
               plain_time=_time_ms, **kw):
        got, m = measure(name, kernel, plain, n_bytes, n_ops, shape,
                         plain_time, **kw)
        rows[name] = {"name": name, "route": "cuda", "source": SOURCES[name],
                      "replaces": REPLACES[name], "launches": 0,
                      "launches_by_path": {}, "shape": shape,
                      "max_abs_err": m["max_abs_err"],
                      "ms": m["ms"], "plain_ms": m["plain_ms"],
                      "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                      "library_ms": m["library_ms"], "variants": [],
                      **{k: m[k] for k in ("blocks_with_feasible", "blocks",
                                           "max_feasible") if k in m}}
        return got

    def variant(name, kernel, plain, n_bytes, n_ops, shape,
                plain_time=_time_ms, **kw):
        """A further input of a recorded kernel: checked and timed the
        same way, kept under the kernel's "variants"."""
        got, m = measure(name, kernel, plain, n_bytes, n_ops, shape,
                         plain_time, **kw)
        rows[name]["variants"].append(m)
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        m["max_abs_err"])
        return got

    def hw_pass(m):
        """Configs that pass area/power: the lanes the search kernels carry
        into the dataflow half (their early exit), in this run's data."""
        return int(((m[0] < cons.area_mm2) & (m[1] < cons.power_w)).sum())

    # -- kernels 1-2: the paper's 12^5 grid, deit-b -----------------------
    grid12, cols, mask = inp.grid12, inp.cols, inp.mask
    g = len(grid12)
    metrics = record(
        "dse_eval_padded",
        lambda: dse.dse_eval_padded(cols, gemms=gemms, wl_scalars=wl_scalars,
                                    constants=CONSTANTS),
        lambda: dse.dse_eval_padded_plain(cols, gemms=gemms,
                                          wl_scalars=wl_scalars,
                                          constants=CONSTANTS),
        n_bytes=(5 + 4) * 4 * g, n_ops=g * (HW_OPS + wl_ops),
        shape=f"(5, {g}) deit-b")
    # Kernel 1's other launch paths at a grid's size: the columns in a
    # seeded random order (quads whose lanes differ above lambda are priced
    # one lane at a time), and one row short (G % 4 != 0: one lane a
    # thread).
    perm = torch.randperm(g, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(17))
    cols_p = cols[:, perm].contiguous()
    quads_p = cols_p[:4].reshape(4, g // 4, 4)
    mixed = int((quads_p != quads_p[:, :, :1]).any(0).any(1).sum())
    for cols_v, what in ((cols_p, f"columns permuted, {mixed} of {g // 4} "
                                  f"quads mixed above lambda"),
                         (cols[:, :g - 1].contiguous(), "one row short")):
        variant(
            "dse_eval_padded",
            lambda c=cols_v: dse.dse_eval_padded(
                c, gemms=gemms, wl_scalars=wl_scalars, constants=CONSTANTS),
            lambda c=cols_v: dse.dse_eval_padded_plain(
                c, gemms=gemms, wl_scalars=wl_scalars, constants=CONSTANTS),
            n_bytes=(5 + 4) * 4 * cols_v.shape[1],
            n_ops=cols_v.shape[1] * (HW_OPS + wl_ops),
            shape=f"(5, {cols_v.shape[1]}) deit-b, {what}")
    del cols_p, quads_p
    workloads = inp.workloads
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
    workloads5, cons5, carry5 = inp.workloads5, inp.cons5, inp.carry5

    def dataflow_ops(passes):
        """Each of the five workloads' dataflow half and search tail on
        its area/power survivors."""
        return sum(n * (WL_FIXED_OPS + WL_PER_GEMM_OPS * len(gm)
                        + SEARCH_TAIL_OPS)
                   for n, (gm, _) in zip(passes, workloads5))

    pass12_5 = [hw_pass(dse.dse_eval_padded(
        cols, gemms=gm, wl_scalars=sc, constants=CONSTANTS))
        for gm, sc in workloads5]
    variant(
        "dse_search_padded",
        lambda: dse.dse_search_padded(cols, mask, cons5, carry5,
                                      workloads=workloads5,
                                      constants=CONSTANTS),
        lambda: dse.dse_search_padded_plain(cols, mask, cons5, carry5,
                                            workloads=workloads5,
                                            constants=CONSTANTS),
        n_bytes=((5 + 1) * 4 * g
                 + 3 * 4 * len(workloads5) * math.ceil(g / dse.BLOCK)),
        n_ops=(g * (HW_OPS + (len(workloads5) - 1) * HW_TAIL_OPS)
               + dataflow_ops(pass12_5)),
        shape=f"(5, {g}), the five paper workloads, {pass12_5} pass "
              f"area/power")

    # -- kernels 3-4: the whole 24^5 product space, then one slab ---------
    space24, axes, radices = inp.space24, inp.axes, inp.radices
    n24, meta = inp.n24, inp.meta
    nr = math.ceil(n24 / dse.BLOCK)
    decoded = record(
        "dse_decode_rows",
        lambda: dse.dse_decode_rows(axes, meta, radices=radices,
                                    n_blocks=nr),
        lambda: dse.dse_decode_rows_plain(axes, meta, radices=radices,
                                          n_blocks=nr),
        n_bytes=6 * 4 * nr * dse.BLOCK, n_ops=nr * dse.BLOCK * DECODE_OPS,
        shape=f"24^5 span [0, {n24})")
    cfg24 = inp.cols24
    _check(torch.equal(cfg24, decoded[:5, :n24]),
           "the 24^5 config columns differ from dse_decode_rows' rows")
    del decoded
    # Kernel 1 at its other shapes: the whole 24^5 space (the throughput
    # shape) and the running front the Pareto BnB prices between frontier
    # launches (search._cuda_front_points; bert-b's 24^5 front, one CTA).
    variant(
        "dse_eval_padded",
        lambda: dse.dse_eval_padded(cfg24, gemms=gemms,
                                    wl_scalars=wl_scalars,
                                    constants=CONSTANTS),
        lambda: dse.dse_eval_padded_plain(cfg24, gemms=gemms,
                                          wl_scalars=wl_scalars,
                                          constants=CONSTANTS),
        n_bytes=(5 + 4) * 4 * n24, n_ops=n24 * (HW_OPS + wl_ops),
        shape=f"(5, {n24}) deit-b, the 24^5 space")
    cols_f, front = inp.cols_front, inp.front
    g_f = len(front)
    kf = dict(gemms=inp.gemms_front, wl_scalars=inp.wl_scalars_front,
              constants=CONSTANTS)
    variant(
        "dse_eval_padded",
        lambda: dse.dse_eval_padded(cols_f, **kf),
        lambda: dse.dse_eval_padded_plain(cols_f, **kf),
        n_bytes=(5 + 4) * 4 * g_f,
        n_ops=g_f * (HW_OPS + WL_FIXED_OPS
                     + WL_PER_GEMM_OPS * len(inp.gemms_front)),
        shape=f"(5, {g_f}) bert-b's 24^5 Pareto BnB front")
    # The host round trip the Pareto BnB pays a batch: rows in, metrics out.
    walls = []
    for _ in range(21):
        t0 = time.perf_counter()
        ops.dse_eval_grid(front, inp.wl_front, CONSTANTS, device=dev)
        walls.append(time.perf_counter() - t0)
    front_wall_ms = statistics.median(walls[1:]) * 1e3
    rows["dse_eval_padded"]["variants"][-1]["dse_eval_grid_wall_ms"] = \
        front_wall_ms
    print(f"ops.dse_eval_grid ({g_f}, 5) rows, bert-b: {front_wall_ms:.4f} "
          f"ms wall a call (copies in and out, launch, sync; median of 20)")
    pass24 = hw_pass(dse.dse_eval_padded(
        cfg24, gemms=gemms, wl_scalars=wl_scalars, constants=CONSTANTS))
    pass24_5 = [hw_pass(dse.dse_eval_padded(
        cfg24, gemms=gm, wl_scalars=sc, constants=CONSTANTS))
        for gm, sc in workloads5]
    del cfg24, inp.cols24
    nb = math.ceil(n24 / dse.DECODE_BLOCK)

    def walk_ops(meta_, n_lanes, n_wl):
        """Decode and area/power operations of a decoded launch of n_wl
        workloads over n_lanes lanes from meta_[0], counted as the walk over
        runs of RUN_LANES lanes does them (above), in this run's slab: the
        terms above lambda once per run and upper digits holding a member,
        the lambda terms and each workload's tail once per member."""
        _, _, valid = dse._decode_block_plain(radices, axes, meta_, 1,
                                              n_lanes)
        pos = torch.arange(n_lanes, dtype=torch.int64, device=dev)
        gidx = int(meta_[0]) + pos
        r_l = int(radices[4])
        runs = n_lanes // RUN_LANES
        wraps = int(((gidx % r_l == 0) & (pos % RUN_LANES != 0)).sum())
        group = ((pos // RUN_LANES) << 32) + gidx // r_l
        group = group[valid]
        n_members = group.numel()
        n_groups = (int((group[1:] != group[:-1]).sum()) + 1
                    if n_members else 0)
        return (runs * DECODE_OPS
                + (n_lanes - runs) * (STEP_OPS + SLAB_LANE_OPS)
                + wraps * (CARRY_OPS + SLAB_UPPER_OPS)
                + n_groups * UPPER_OPS
                + n_members * (LANE_HW_OPS + n_wl * HW_TAIL_OPS))

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
        n_ops=(walk_ops(meta, nb * dse.DECODE_BLOCK, 1)
               + pass24 * (wl_ops + SEARCH_TAIL_OPS)),
        shape=f"24^5 span [0, {n24}) deit-b, {pass24} pass area/power")
    variant(
        "dse_search_decoded",
        lambda: dse.dse_search_decoded(axes, meta, cons5, carry5,
                                       radices=radices, n_blocks=nb,
                                       workloads=workloads5,
                                       constants=CONSTANTS),
        lambda: dse.dse_search_decoded_plain(axes, meta, cons5, carry5,
                                             radices=radices, n_blocks=nb,
                                             workloads=workloads5,
                                             constants=CONSTANTS),
        n_bytes=axes.numel() * 4 + 3 * 4 * len(workloads5) * nb,
        n_ops=(walk_ops(meta, nb * dse.DECODE_BLOCK, len(workloads5))
               + dataflow_ops(pass24_5)),
        shape=f"24^5 span, the five paper workloads (factorized "
              f"search_workloads), {pass24_5} pass area/power")
    slab, b0, b1, meta_s = inp.slab, inp.b0, inp.b1, inp.meta_s
    nb_s = math.ceil((b1 - b0) / dse.DECODE_BLOCK)
    nr_s = math.ceil((b1 - b0) / dse.BLOCK)
    members = space24.decode(slab_indices(radices, slab))
    pass_s = hw_pass(dse.dse_eval_padded(
        torch.from_numpy(members.T.astype("float32")).contiguous().to(dev),
        gemms=gemms, wl_scalars=wl_scalars, constants=CONSTANTS))
    kw = dict(radices=radices, n_blocks=nb_s, workloads=workloads,
              constants=CONSTANTS)
    variant(
        "dse_search_decoded",
        lambda: dse.dse_search_decoded(axes, meta_s, cons_row, carry, **kw),
        lambda: dse.dse_search_decoded_plain(axes, meta_s, cons_row, carry,
                                             **kw),
        n_bytes=axes.numel() * 4 + 3 * 4 * nb_s,
        n_ops=(walk_ops(meta_s, nb_s * dse.DECODE_BLOCK, 1)
               + pass_s * (wl_ops + SEARCH_TAIL_OPS)),
        shape=f"24^5 slab {slab}, span [{b0}, {b1}), {len(members)} "
              f"members, {pass_s} pass area/power")
    # 40 workloads: more than a pass over the lanes serves (32), so the
    # search kernels take them in two passes.
    w40 = workloads5 * 8
    cons40, carry40 = cons5.repeat(8, 1), carry5.repeat(8, 1)
    for name, got, want, where in (
            ("dse_search_padded",
             dse.dse_search_padded(cols, mask, cons40, carry40,
                                   workloads=w40, constants=CONSTANTS),
             dse.dse_search_padded_plain(cols, mask, cons40, carry40,
                                         workloads=w40, constants=CONSTANTS),
             "12^5"),
            ("dse_search_decoded",
             dse.dse_search_decoded(axes, meta_s, cons40, carry40,
                                    radices=radices, n_blocks=nb_s,
                                    workloads=w40, constants=CONSTANTS),
             dse.dse_search_decoded_plain(axes, meta_s, cons40, carry40,
                                          radices=radices, n_blocks=nb_s,
                                          workloads=w40, constants=CONSTANTS),
             "the 24^5 slab")):
        rows[name]["max_abs_err"] = max(
            rows[name]["max_abs_err"],
            check_equal(name, got, want, f"{where}, 40 workloads"))
    print("both search kernels equal to plain with 40 workloads (two "
          "passes over the lanes)")
    rows["dse_decode_rows"]["max_abs_err"] = max(
        rows["dse_decode_rows"]["max_abs_err"], check_equal(
            "dse_decode_rows",
            dse.dse_decode_rows(axes, meta_s, radices=radices, n_blocks=nr_s),
            dse.dse_decode_rows_plain(axes, meta_s, radices=radices,
                                      n_blocks=nr_s),
            "a 24^5 slab"))
    print(f"24^5 slab {slab}, span [{b0}, {b1}): dse_decode_rows equal to "
          f"plain")
    torch.cuda.empty_cache()

    # -- kernels 5-6: the frontier kernels, deit-b, (area, power, edp) ----
    golden = inp.golden
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
    n_words = dse._device_params(workloads, CONSTANTS, dev).numel()
    print("dse_pareto dynamic smem: " + ", ".join(
        f"d {d_} {load_library('dse_eval').dse_pareto_smem_bytes(d_, n_words)}"
        f" B" for d_ in (3, 5)))

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
    dup, cols_dup, mask_dup = inp.dup, inp.cols_dup, inp.mask_dup
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
        n_ops=lambda out: (walk_ops(meta, np24 * dse.BLOCK, 1)
                           + pass24 * (wl_ops + PARETO_TAIL_OPS)
                           + dominance_ops(out, False)),
        shape=f"24^5 span [0, {n24}) deit-b, {pass24} pass area/power",
        plain_time=plain_slow)
    variant(
        "dse_pareto_decoded",
        lambda: dse.dse_pareto_decoded(axes, meta_s, cons_row, no_carry,
                                       n_blocks=nr_s, has_carry=False, **dk),
        lambda: dse.dse_pareto_decoded_plain(axes, meta_s, cons_row,
                                             no_carry, n_blocks=nr_s,
                                             has_carry=False, **dk),
        n_bytes=axes.numel() * 4 + 4 * dse.PARETO_ROWS * nr_s,
        n_ops=lambda out: (walk_ops(meta_s, nr_s * dse.BLOCK, 1)
                           + pass_s * (wl_ops + PARETO_TAIL_OPS)
                           + dominance_ops(out, False)),
        shape=f"24^5 slab, {len(members)} members, {pass_s} pass area/power",
        plain_time=plain_slow)
    # Feasible lanes whose objective 0 is +inf: at a clock of 2e-11 Hz the
    # latencies reach ~1e19 s and EDP overflows float32 on some lanes; with
    # energy and latency left open those lanes stay feasible, so a block
    # holding one sorts all its lanes (the frontier template's all-lanes
    # branch), the masked and over-budget lanes joining as +inf rows.
    slow = dataclasses.replace(CONSTANTS, f_clk_hz=2e-11)
    gemms_o, wl_scalars_o = workload_statics(wl, slow)
    cons_open = torch.tensor([[cons.area_mm2, cons.power_w, math.inf,
                               math.inf]], dtype=torch.float32, device=dev)
    mask_odd = (torch.arange(g, device=dev) % 4 != 3).to(torch.float32)[None]
    ko = dict(workloads=((gemms_o, wl_scalars_o),), objectives=objs,
              constants=slow)
    for label, cfg_, keep in (
            ("12^5, every fourth lane masked", cols, mask_odd[0] > 0),
            ("24^5 slab", torch.from_numpy(members.T.astype("float32"))
             .contiguous().to(dev), None)):
        m_o = dse.dse_eval_padded(cfg_, gemms=gemms_o,
                                  wl_scalars=wl_scalars_o, constants=slow)
        ok_o = (m_o[0] < cons.area_mm2) & (m_o[1] < cons.power_w)
        if keep is not None:
            ok_o &= keep
        n_inf = int((ok_o & ~torch.isfinite(m_o[2] * m_o[3])).sum())
        n_ok = int(ok_o.sum())
        _check(0 < n_inf < n_ok,
               f"{label} at 2e-11 Hz: {n_inf} of {n_ok} feasible lanes with "
               f"EDP +inf (the case needs some, not all)")
        print(f"{label} at 2e-11 Hz: {n_inf} of {n_ok} feasible lanes with "
              f"objective 0 (EDP) +inf")
    n_bytes, n_ops = padded_work(cols, False)
    variant(
        "dse_pareto_padded",
        lambda: dse.dse_pareto_padded(cols, mask_odd, cons_open, no_carry,
                                      has_carry=False, **ko),
        lambda: dse.dse_pareto_padded_plain(cols, mask_odd, cons_open,
                                            no_carry, has_carry=False, **ko),
        n_bytes=n_bytes, n_ops=n_ops,
        shape=f"(5, {g}) deit-b at 2e-11 Hz, every fourth lane masked, "
              f"EDP +inf on feasible lanes",
        plain_time=plain_slow)
    variant(
        "dse_pareto_decoded",
        lambda: dse.dse_pareto_decoded(axes, meta_s, cons_open, no_carry,
                                       n_blocks=nr_s, has_carry=False,
                                       radices=radices, **ko),
        lambda: dse.dse_pareto_decoded_plain(axes, meta_s, cons_open,
                                             no_carry, n_blocks=nr_s,
                                             has_carry=False,
                                             radices=radices, **ko),
        n_bytes=axes.numel() * 4 + 4 * dse.PARETO_ROWS * nr_s,
        n_ops=lambda out: (walk_ops(meta_s, nr_s * dse.BLOCK, 1)
                           + pass_s * (wl_ops + PARETO_TAIL_OPS)
                           + dominance_ops(out, False)),
        shape="24^5 slab at 2e-11 Hz, EDP +inf on feasible lanes",
        plain_time=plain_slow)
    torch.cuda.empty_cache()

    def drive(path, fn, needs):
        """One call of a kernel path through its entry point, with every
        launch count set to 0 just before it and read just after; fails
        unless each kernel in `needs` was launched in that call."""
        for c in counters:
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: n for c in counters for k, n in c.items()}
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

    # -- the torch engine: the cost model, masking, argmin and frontier scan
    # in plain torch float32 on the card, no hand-written kernel ----------
    from repro_torch.core.search import _torch_space_metrics

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def edp_keys(r):
        return (r.best_cfg, r.edp, r.n_feasible)

    for c in counters:
        for k in c:
            c[k] = 0
    torch_walls = {}
    for objective in ("edp", "pareto"):
        def batch(engine):
            return search_workloads(wls, cons, engine=engine,
                                    objective=objective, device=dev)
        got, t_cold = timed(lambda: batch("torch"))
        again, t_warm = timed(lambda: batch("torch"))
        want, t_np = timed(lambda: batch("numpy"))
        for n in names:
            gold = golden["workloads"][n]
            if objective == "edp":
                _check([int(x) for x in got[n].best_cfg.as_array()]
                       == gold["best"] and got[n].edp == gold["edp"]
                       and got[n].n_feasible == gold["n_feasible"]
                       and edp_keys(got[n]) == edp_keys(want[n])
                       == edp_keys(again[n]),
                       f"torch 12^5 {n}: winner or n_feasible differs from "
                       f"the golden record or the numpy engine")
            else:
                _check(golden_front(got[n], n)
                       and same_front(got[n], want[n], ("n_feasible",))
                       and same_front(again[n], got[n]),
                       f"torch 12^5 pareto {n}: the frontier differs from "
                       f"the golden record or the numpy engine")
        torch_walls[f"search_workloads 12^5 {objective}"] = (t_cold, t_warm,
                                                             t_np)
        print(f"torch search_workloads 12^5 {objective} (5 workloads, "
              f"flat): golden and numpy agree; torch {t_cold:.4f} s cold, "
              f"{t_warm:.4f} s warm; numpy {t_np:.4f} s")
    # one streamed and one factorized query, against the numpy engine
    for label, kw, n in (
            ("streamed 12^5 chunk_size=50000", dict(chunk_size=50_000),
             "deit-b"),
            ("factorized 12^5 pareto", dict(factorized=True, space=space12,
                                            objective="pareto"), "bert-b")):
        got, t_t = timed(lambda: search(wls[n], cons, engine="torch",
                                        device=dev, **kw))
        want = search(wls[n], cons, engine="numpy", device=dev, **kw)
        _check((golden_front(got, n) and same_front(got, want,
                                                    ("n_feasible",)))
               if "pareto" in label else
               (edp_keys(got) == edp_keys(want)
                and [int(x) for x in got.best_cfg.as_array()]
                == golden["workloads"][n]["best"]),
               f"torch {label} {n}: differs from the numpy engine")
        print(f"torch {label} {n}: golden and numpy agree; {t_t:.4f} s")
    # the production form at 24^5: every counter and the frontier equal
    # numpy's exactly
    bnb_keys = ("n_feasible", "n_workload_evals", "n_pruned", "n_bounds")
    for objective in ("edp", "pareto"):
        def tbnb(engine):
            return search(wls["deit-b"], cons, engine=engine,
                          factorized=True, space=space24, prune="bound",
                          objective=objective, device=dev)
        got, t_cold = timed(lambda: tbnb("torch"))
        again, t_warm = timed(lambda: tbnb("torch"))
        want, t_np = timed(lambda: tbnb("numpy"))
        for r in (got, again):
            _check(all(getattr(r, k) == getattr(want, k) for k in bnb_keys)
                   and (edp_keys(r) == edp_keys(want) if objective == "edp"
                        else same_front(r, want)),
                   f"torch 24^5 prune=bound {objective} deit-b: "
                   f"{[getattr(r, k) for k in bnb_keys]} vs numpy "
                   f"{[getattr(want, k) for k in bnb_keys]}")
        torch_walls[f"24^5 prune=bound {objective} deit-b"] = (t_cold, t_warm,
                                                               t_np)
        print(f"torch 24^5 prune=bound {objective} deit-b: counters "
              f"{[getattr(got, k) for k in bnb_keys]} and "
              f"{'winner' if objective == 'edp' else f'{got.size} rows'} "
              f"equal numpy's; torch {t_cold:.4f} s cold, {t_warm:.4f} s "
              f"warm; numpy {t_np:.4f} s")
    # The float32 metric arrays on the card equal the engine's CPU arrays
    # bit for bit (held against the reference in tests/test_torch_engine.py)
    idx = torch.from_numpy(slab_indices(radices, slab))
    m_dev = _torch_space_metrics(space24, wls["deit-b"], CONSTANTS, dev,
                                 idx.to(dev))
    m_cpu = _torch_space_metrics(space24, wls["deit-b"], CONSTANTS,
                                 torch.device("cpu"), idx)
    for k, v in m_cpu.items():
        _check(torch.equal(m_dev[k].cpu(), v),
               f"torch engine float32 {k} on the card differs from the CPU "
               f"on the 24^5 slab")
    counts = {k: n for c in counters for k, n in c.items()}
    _check(not any(counts.values()),
           f"the torch engine launched a hand-written kernel: {counts}")
    print(f"torch engine: float32 metrics of the {len(idx)} slab members "
          f"equal on the card and the CPU bit for bit; no kernel launched "
          f"in the phase ({counts})")
    # the cuda engine's warm wall times for the same queries, same call
    for objective in ("edp", "pareto"):
        search_workloads(wls, cons, engine="cuda", objective=objective,
                         device=dev)
        _, t_cuda = timed(lambda: search_workloads(
            wls, cons, engine="cuda", objective=objective, device=dev))
        t_cold, t_warm, t_np = torch_walls[f"search_workloads 12^5 "
                                           f"{objective}"]
        print(f"warm wall, search_workloads 12^5 {objective}: torch "
              f"{t_warm:.4f} s, numpy {t_np:.4f} s, cuda {t_cuda:.4f} s")
        _, t_cuda = timed(lambda: search(
            wls["deit-b"], cons, engine="cuda", factorized=True,
            space=space24, prune="bound", objective=objective, device=dev))
        t_cold, t_warm, t_np = torch_walls[f"24^5 prune=bound {objective} "
                                           f"deit-b"]
        print(f"warm wall, 24^5 prune=bound {objective} deit-b: torch "
              f"{t_warm:.4f} s, numpy {t_np:.4f} s, cuda {t_cuda:.4f} s")

    # -- the resident service on the card (phase 4c) ----------------------
    def drive_into(path):
        """`drive` for the service, scenario and worker phases: the counts
        of every call add up under the one path `path`."""
        return lambda label, fn, needs: drive_path(path, label, fn, needs)

    def drive_path(path, label, fn, needs):
        for c in counters:
            for k in c:
                c[k] = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: n for c in counters for k, n in c.items()}
        for name in needs:
            _check(counts[name] > 0, f"{path} {label}: never launched "
                                     f"{name}")
        for name, n in counts.items():
            if n:
                rows[name]["launches"] += n
                by_path = rows[name]["launches_by_path"]
                by_path[path] = by_path.get(path, 0) + n
        return out, wall, counts

    service_walls = service_phase(dev, 24, smi.stdout.strip(),
                                  drive_into("service"), float32_ties)
    # -- the model-zoo scenario sweep (phase 4d) ---------------------------
    scenario_walls = scenario_phase(dev, 24, smi.stdout.strip(),
                                    drive_into("scenarios"), float32_ties)
    # -- the parallel slab scheduler (phase 4e) ----------------------------
    with LaunchesByThread(load_library("dse_eval")) as by_thread:
        worker_walls = workers_phase(dev, 24, smi.stdout.strip(),
                                     drive_into("workers"), float32_ties,
                                     by_thread)

    # -- kernel 7: the photonic DDot GEMM, at the serving path's shapes ----
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def ddot_operands(m, k, n, k_major):
        """Quantized operands; with k_major, b is the transposed view of an
        (n, k) tensor (the LM head's `table.T`), so qb.T is contiguous and
        the kernel reads it without a copy."""
        a = torch.randn((m, k), generator=gen, device=dev)
        b = (torch.randn((n, k), generator=gen, device=dev).T if k_major
             else torch.randn((k, n), generator=gen, device=dev))
        qa, sa = quantize4(a, axis=1)
        qb, sb = quantize4(b, axis=0)
        qb = qb.to(torch.int8)
        _check(qb.T.is_contiguous() is k_major,
               f"ddot operand layout: qb.T contiguous is not {k_major}")
        z = torch.randn((m, n), generator=gen, device=dev)
        return qa.to(torch.int8), qb, sa, sb, z

    def ddot_case(m, k, n, noise, k_major, main=False):
        qa, qb, sa, sb, z = ddot_operands(m, k, n, k_major)
        noisy = noise > 0.0
        n_bytes = (m * k + k * n + 4 * (m + n) + 4 * m * n
                   + (4 * m * n if noisy else 0))
        n_ops = 2 * m * n * k * (2 if noisy else 1)
        library = None
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            # torch._int_mm (int8 x int8 -> int32) computes the exact
            # accumulation; its shape rules want M > 16, K and N % 8 == 0
            library = lambda: torch._int_mm(qa, qb)  # noqa: E731
        layout = "B K-major (no copy)" if k_major else "B row-major"
        (record if main else variant)(
            "ddot_gemm_quantized",
            lambda: ddot.ddot_gemm_quantized(qa, qb, sa, sb, z,
                                             noise_rms=noise),
            lambda: ddot.ddot_gemm_quantized_plain(qa, qb, sa, sb, z,
                                                   noise_rms=noise),
            n_bytes=n_bytes, n_ops=n_ops, ops_per_s=INT8_OPS_PER_S,
            shape=f"({m}, {k}) x ({k}, {n}), noise_rms {noise}, {layout}",
            library=library)
        if not k_major and not noisy and k * n >= 1 << 20:
            # a row-major B costs the wrapper one K-major copy a call
            print(f"ddot_gemm_quantized ({k}, {n}) row-major B: the "
                  f"wrapper's K-major copy takes "
                  f"{_time_ms(lambda: ddot.k_major(qb)):.4f} ms")

    qcfg = get_config("qwen2.5-3b")
    ddot_case(4, qcfg.d_model, qcfg.vocab, 0.0, True, main=True)
    ddot_case(4, qcfg.d_model, qcfg.vocab, 0.02, True)
    for k_major in (True, False):
        ddot_case(256, qcfg.d_model, qcfg.d_ff, 0.0, k_major)
    ddot_case(256, qcfg.d_model, qcfg.d_ff, 0.02, False)
    for k_major in (False, True):
        ddot_case(33, 1000, 257, 0.0, k_major)
        ddot_case(33, 1000, 257, 0.02, k_major)
    torch.cuda.empty_cache()

    # -- kernel 8: fused attention, on wgmma (bf16, D % 8 == 0) and on
    # mma.sync in TF32 (f32, other head dims) ----------------------------
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    def flash_case(bh, s_len, d, group, dtype, causal, main=False):
        q = torch.randn((bh, s_len, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((bh // group, s_len, d), generator=gen,
                        device=dev).to(dtype)
        v = torch.randn((bh // group, s_len, d), generator=gen,
                        device=dev).to(dtype)
        size = q.element_size()
        n_bytes = size * d * s_len * (2 * bh + 2 * (bh // group))
        n_ops = 4 * bh * s_len * s_len * d / (2 if causal else 1)
        name = ("flash_attention_bhsd" if wgmma_path(dtype, d)
                else "flash_attention_bhsd_tf32")
        tiling = ("" if name == "flash_attention_bhsd" else
                  f", {tf32_splits(bh, s_len, s_len, d, n_sm)} key splits")

        def kernel():
            return flash_attention_bhsd(q, k, v, causal=causal, group=group)

        def library():
            # one batch of bh query heads over bh // group KV heads
            return torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=causal,
                enable_gqa=group > 1)

        before = dict(FA_LAUNCHES)
        kernel()
        ran = {n: FA_LAUNCHES[n] - before[n] for n in FA_LAUNCHES}
        _check(ran == {n: int(n == name) for n in FA_LAUNCHES},
               f"flash_attention_bhsd D {d} {dtype}: launched {ran}, "
               f"expected one {name}")
        (record if main else variant)(
            name, kernel,
            lambda: flash_attention_bhsd_plain(q, k, v, causal=causal,
                                               group=group),
            n_bytes=n_bytes, n_ops=n_ops,
            ops_per_s=(BF16_OPS_PER_S if dtype == torch.bfloat16
                       else F32_OPS_PER_S),
            shape=(f"BH {bh}, S {s_len}, D {d}, group {group}, "
                   f"{str(dtype)[6:]}, {'causal' if causal else 'bidirectional'}"
                   f"{tiling}"),
            tol=FLASH_TOL[str(dtype)], library=library)

    group = qcfg.n_heads // qcfg.n_kv_heads
    bf16, f32 = torch.bfloat16, torch.float32
    flash_case(qcfg.n_heads, 4096, qcfg.resolved_head_dim, group, bf16, True,
               main=True)
    for d_ in (56, 64, 80, 112, 256):
        flash_case(8, 200, d_, 4, bf16, True)
    flash_case(4, 256, 128, 1, bf16, False)
    flash_case(4, 256, 128, 1, f32, False, main=True)
    for d_ in (80, 256):
        flash_case(8, 200, d_, 4, f32, True)
    # wider grids: 128 query blocks (two key splits at D 128, one past
    # it, where a block takes 200 KB of shared memory) and 256 (one split)
    flash_case(16, 512, 128, 1, f32, False)
    flash_case(16, 512, 256, 4, f32, True)
    flash_case(32, 512, 128, 8, f32, False)
    flash_case(8, 200, 36, 4, bf16, True)
    torch.cuda.empty_cache()

    # -- the serving path: qwen2.5-3b at full width -------------------------
    # A reduced qwen2.5-3b on the card against the port's CPU path (held
    # against repro in tests/test_torch_lm.py), same weights and prompts.
    small_cfg = reduced(qcfg)
    small_cpu = models.init_params(small_cfg,
                                   torch.Generator().manual_seed(1), "cpu")
    small_dev = models.init_params(small_cfg,
                                   torch.Generator().manual_seed(1), "cpu")
    small_dev = small_dev.to(dev)
    toks = np.random.default_rng(1).integers(
        1, small_cfg.vocab, size=(4, 10)).astype(np.int32)
    with torch.inference_mode():
        l_cpu, _ = models.prefill(small_cpu, small_cfg,
                                  {"tokens": torch.from_numpy(toks)})
        l_dev, _ = models.prefill(small_dev, small_cfg,
                                  {"tokens": torch.from_numpy(toks).to(dev)})
    err = float((l_dev.cpu() - l_cpu).abs().max())
    _check(err <= LOGIT_ATOL, f"reduced qwen2.5-3b prefill logits: card vs "
           f"CPU path differ by {err!r} > {LOGIT_ATOL}")
    print(f"reduced qwen2.5-3b prefill: card within {err!r} of the CPU path")
    del small_cpu, small_dev

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_params(qcfg, gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"qwen2.5-3b (full width, {qcfg.n_layers} layers): {n_params} "
          f"parameters, {n_params * 2 / 1e9:.2f} GB bf16, built in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, qcfg.vocab, size=rng.integers(4, 12))
               .astype(np.int32) for _ in range(4)]
    with torch.inference_mode():
        plen = max(len(p_) for p_ in prompts)
        batch = np.zeros((4, plen), np.int32)
        for i, p_ in enumerate(prompts):
            batch[i, plen - len(p_):] = p_
        logits, cache = models.prefill(
            params, qcfg, {"tokens": torch.from_numpy(batch).to(dev)})
        _check(tuple(logits.shape) == (4, qcfg.vocab)
               and bool(torch.isfinite(logits).all())
               and tuple(cache["k"].shape) == (
                   qcfg.n_layers, 4, plen, qcfg.n_kv_heads,
                   qcfg.resolved_head_dim),
               "qwen2.5-3b prefill: logits not finite or shapes wrong")
    del logits, cache
    srv = Server(qcfg, params, batch_size=4, max_len=64, device=dev)
    for run in ("first", "second"):
        reqs = [Request(prompt=p_, max_new=12) for p_ in prompts]
        stats, _ = drive(f"serve qwen2.5-3b 4x12 ({run})",
                         lambda: srv.generate(reqs), needs=())
        _check(all(len(r.out) == 12 and all(0 <= t_ < qcfg.vocab
                                            for t_ in r.out) for r in reqs)
               and stats["tokens"] == 48,
               "qwen2.5-3b serving: wrong number of tokens or ids")
        print(f"serve qwen2.5-3b ({run} call): {stats['tokens']} tokens, "
              f"ttft_s {stats['ttft_s']!r}, decode_s_per_tok "
              f"{stats['decode_s_per_tok']!r}; request 0: {reqs[0].out}")
    print(f"serving peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    x = torch.randn((4, qcfg.d_model), generator=gen, device=dev)
    table_t = params.embed.table.T.float()
    exact = x @ table_t
    for noise in (0.02, 0.0):
        head, t_head = drive(
            f"photonic LM head noise_rms {noise}",
            lambda: ops.photonic_matmul(x, table_t, noise, key_data=7),
            needs=("ddot_gemm_quantized",))
        rel = float(torch.linalg.norm(head - exact)
                    / torch.linalg.norm(exact))
        _check(bool(torch.isfinite(head).all())
               and tuple(head.shape) == (4, qcfg.vocab),
               f"photonic LM head (noise {noise}): not finite")
        if noise == 0.0:
            _check(rel < 0.25, f"photonic LM head without noise: relative "
                   f"error {rel!r} >= 0.25 (tests/test_kernels.py's bound)")
        print(f"photonic LM head (4-bit DDot kernel, noise_rms {noise}): "
              f"rel_err {rel!r} vs fp32, {t_head * 1e3:.3f} ms")
    del table_t, exact, srv
    print("photonic_report:", photonic_report(qcfg, seq_len=64, batch=4,
                                              new_tokens=12, device=dev))
    del params
    torch.cuda.empty_cache()

    # -- the attention entry point at qwen2.5-3b's attention shape ---------
    b, s_len, d = 1, 4096, qcfg.resolved_head_dim
    qh = torch.randn((b, s_len, qcfg.n_heads, d), generator=gen,
                     device=dev).to(torch.bfloat16)
    kh, vh = (torch.randn((b, s_len, qcfg.n_kv_heads, d), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    out, t_fa = drive("flash_attention qwen2.5-3b S 4096",
                      lambda: ops.flash_attention(qh, kh, vh, causal=True),
                      needs=("flash_attention_bhsd",))
    want = flash_attention_bhsd_plain(
        qh.permute(0, 2, 1, 3).reshape(b * qcfg.n_heads, s_len, d),
        kh.permute(0, 2, 1, 3).reshape(b * qcfg.n_kv_heads, s_len, d),
        vh.permute(0, 2, 1, 3).reshape(b * qcfg.n_kv_heads, s_len, d),
        causal=True, group=group)
    want = want.reshape(b, qcfg.n_heads, s_len, d).permute(0, 2, 1, 3)
    check_close("flash_attention (entry point)", out, want,
                "(1, 4096, 16, 128) bf16", FLASH_TOL["torch.bfloat16"])
    print(f"flash_attention entry point (1, 4096, 16/2 heads, 128) bf16: "
          f"within tolerance, {t_fa * 1e3:.3f} ms with its layout copies")
    # f32 takes the TF32 kernel (3xTF32 products)
    q32, k32, v32 = (x[:, :512].float() for x in (qh, kh, vh))
    s_len = q32.shape[1]
    out, t_fa = drive("flash_attention qwen2.5-3b S 512 f32",
                      lambda: ops.flash_attention(q32, k32, v32, causal=True),
                      needs=("flash_attention_bhsd_tf32",))
    want = flash_attention_bhsd_plain(
        q32.permute(0, 2, 1, 3).reshape(b * qcfg.n_heads, s_len, d),
        k32.permute(0, 2, 1, 3).reshape(b * qcfg.n_kv_heads, s_len, d),
        v32.permute(0, 2, 1, 3).reshape(b * qcfg.n_kv_heads, s_len, d),
        causal=True, group=group)
    want = want.reshape(b, qcfg.n_heads, s_len, d).permute(0, 2, 1, 3)
    check_close("flash_attention (entry point, f32)", out, want,
                "(1, 512, 16, 128) f32", FLASH_TOL["torch.float32"])
    print(f"flash_attention entry point (1, 512, 16/2 heads, 128) f32: "
          f"within tolerance, {t_fa * 1e3:.3f} ms with its layout copies")

    # -- the other model families at published widths (phase 6b) ----------
    family_rows = families_phase(dev, smi.stdout.strip(), drive, counters)

    print(f"service wall times ({smi.stdout.strip()}): " + "; ".join(
        f"{label} {kind} {wall:.4f} s" for label, kind, wall in service_walls))
    print(f"scenario wall times ({smi.stdout.strip()}): " + "; ".join(
        f"{label} {wall:.4f} s" for label, wall in scenario_walls))
    print(f"worker wall times ({smi.stdout.strip()}): " + "; ".join(
        f"{label} " + (", ".join(f"workers={k} {v:.4f} s"
                                 for k, v in wall.items())
                       if isinstance(wall, dict) else f"{wall:.4f} s")
        for label, wall in worker_walls))
    print(f"family serving ({smi.stdout.strip()}): " + "; ".join(
        f"{arch} ttft {t[0]:.4f} / {t[1]:.4f} s, decode {d[0]:.4f} / "
        f"{d[1]:.4f} s/token, peak {peak:.2f} GiB, built in {b_s:.2f} s"
        for arch, t, d, peak, b_s in family_rows))
    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
