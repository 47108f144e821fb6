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
  4f. drives `shard=` on the main path (`shard_phase`): prints k, the
     cards `shard=4` spans (one here: k = 1, in the sharded layout); the
     12^5 golden searches of the five workloads in both objectives at
     shard=4 and at (shard=2, chunk_size=65536), the 24^5 BnB of deit-b in
     both objectives at shard=4 on the cuda and torch engines, a
     `SearchService(shard=4)`'s cold and warm query and `launch.serve dse
     --shard 4` / `scenarios --shard 2`, each equal byte for byte to the
     same call at shard=None (the 12^5 ones also to the golden record);
     then kernels 2, 3, 5 and 6 through the k = 4 launchers on the one
     card, 4 launches a call, the rebased per-block columns `torch.equal`
     to the unsharded launch's. It prints each call's wall time beside
     shard=None's;
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
  6c. trains on the card (`train_phase`): a reduced model of each family
     (qwen2.5-3b, llava-next-34b, olmoe-1b-7b, deepseek-v3-671b, zamba2-7b,
     rwkv6-7b, seamless-m4t-medium, gemma3-4b) 3 steps of
     `make_train_step`, held against the port's CPU path (loss, and the
     gradient norm from the same state) and run twice on the card; a
     `Trainer` run checkpointed and auto-resumed; `launch.train` in-process,
     plain and as one NCCL rank of a `--coordinator` group (losses held to
     the plain run's, no group left up);
     qwen2.5-3b at its published width (3,397,103,616 parameters, one
     sequence of 4096 tokens, AdamW with f32 moments, remat): step wall
     time, tokens/s, peak device memory, the device busy share of a
     profiled step, its top kernels and its device time by kind (f32
     GEMM, bf16 GEMM, casts, the rest), and the step split into forward,
     backward and the optimizer pass; no hand-written kernel may launch;
  6d. runs the products' bf16 mode (`precision_phase`;
     `models.layers.set_exec_safe(False)`, the reference's default: bf16
     operands into the library's f32-result product), restoring the mode
     after it: (a) the models' 16 einsum equations and `matmul32` at
     qwen2.5-3b's widths (B 4, S 128, the LM head at its 151,936 vocabulary)
     within the summation-order bound of the f32 product on the card, each
     timed beside the exec-safe product; (b) phase 6c's qwen2.5-3b step in
     bf16 mode (same weights and batches: step wall, tokens/s, peak, busy
     share, device time by kind, beside phase 6c's), every step's loss and
     gradient norm within TRAIN_LOSS_ATOL and TRAIN_GNORM_RTOL of phase
     6c's, the first step's gradients leaf by leaf within TRAIN_GNORM_RTOL
     of exec-safe's in norm, and no product on f32 operands; (c)
     `Server.generate` 4 x 12 tokens in each mode (ttft, decode s/token,
     peak), greedy tokens equal wherever the exec-safe top-2 margin exceeds
     MARGIN; (d) `launch.serve tokens --arch qwen2.5-3b` through its `main`
     at full width, every product on the bf16 route; (e) rwkv6-7b cut to
     two layers, forward and backward: every GEMM with a bf16 result runs
     with cuBLAS's bf16 reduced-precision reduction off;
  8. the sharding rules and the multi-pod dry-run (`dryrun_phase`): (a)
     the four cells of the reference's integration tests at published
     widths on abstract "cuda" meshes of 256 or 512 placeholder H100s,
     each `python -m repro_torch.launch.dryrun` in a subprocess (the four
     and the qwen2.5-3b decode_32k cell of (d) at once, in the default
     bf16 mode): granite-3-2b decode_32k (256),
     h2o-danube-1.8b train_4k (512), qwen2.5-3b long_500k (skipped by
     policy) and rwkv6-7b long_500k (256), held to the reference tests'
     assertions, each cell's status, trace seconds, FLOPs, per-device
     bytes, collectives by kind, roofline terms and bottleneck printed;
     (b) qwen2.5-3b at its published width, phase 6c's step (one sequence
     of 4096 tokens, AdamW f32 moments, remat) traced as an abstract cell
     on the host mesh in each product mode, its GEMM FLOPs equal to the
     same counter's count around one real step on the card in that mode,
     equal across the modes and to QWEN_STEP_GEMM_FLOPS, the bf16 trace's
     collective and temp bytes beside the exec-safe one's, no product on
     f32 operands or gathered in bf16 mode, the exec-safe roofline terms
     (and the compute term at the f32 rate) beside phase 6c's measured
     step time and its argument + temp bytes beside the measured peak
     memory; (c) qwen2.5-3b at its published width with DTensor
     parameters from `param_specs` on a one-card mesh over an NCCL group
     of one rank (a FileStore, no network): its prefill logits, and a
     decode step's logits and cache from the prefill's cache, equal the
     NULL_RULES ones bit for bit in exec-safe and in bf16 mode; then in
     bf16 mode (`bf16_on_dtensor`) the f32-result products (`mm.dtype` /
     `bmm.dtype`) called bare on DTensors equal the plain ones, one train
     step (loss, gradient norm, every updated parameter) and two
     `Trainer(shardings=)` steps (cut to one layer) equal the plain bf16
     run's bit for bit; in bf16 mode no product takes f32 operands and
     none is gathered; (d) decode against a sequence-sharded cache
     (`seq_sharded_decode`) on a fake group of 4 ranks, meta shards on a
     (1, 4) mesh: whether DTensor takes `amax` and `sum` over a sharded
     axis as Partial reductions on this torch, then `gqa_attend` (grouped
     and `repeat_kv`, both product modes), `write_row` and `decode_mla`
     with the cache sharded along its sequence, at S and 2S: the
     collective bytes GSPMD gives the reference's for the same shapes
     (GSPMD_DECODE_BYTES), all-reduces alone, the same at both lengths,
     nothing gathered and no view that flattens a sharded dimension that
     does not lead its group (`parallel.sharding.StridedViews`, printed);
     (e) sequence-parallel row-parallel products
     (`seq_parallel_products`) on the same fake group, meta shards: the
     attention and MLP blocks of reduced gemma3-4b (SEQ_PARALLEL_SHAPES),
     and the attention block of reduced qwen2.5-3b, whose one KV head puts
     "model" on K/V's head_dim, in both GQA modes
     (SEQ_PARALLEL_KV_ON_HEAD_DIM), under PREFILL_RULES on (1, 4) (the
     forward) and TRAIN_RULES on (2, 2) (forward and backward), in both
     product modes, their reductions and gathers by kind, dtype and bytes
     printed: every reduction in f32, no f32 Partial sum cast to bf16
     (`PartialCasts`), qwen2.5-3b's prefill reducing no more than the
     residual's reduce-scatter and its train step no more than GSPMD's
     reference (GSPMD_QWEN_TRAIN_REDUCTION_BYTES: no f32 scores reduced),
     the ops `GatherFallback` gathered and the strided views printed, no
     view among the gathered ops and no strided view (the lowering plans
     its flattens on the operands' layout: grouped mode's (G, S) with S
     sharded among them); and (a) runs
     qwen2.5-3b decode_32k single too, its all-gather bytes a card printed
     before the phase's wall time and held to QWEN_DECODE_ALL_GATHER_MAX;
     no hand-written kernel may launch;
  8b. runs the four examples (`examples/*_torch.py`, `examples_phase`),
     each through its `main([...])` on the card: quickstart's result equal
     to its `--device cpu` run (no launch); arch_cosearch's zoo table on
     the cuda, torch, python and numpy engines, row for row equal, then
     `--scenarios` with and without `--pareto` on cuda equal to numpy,
     `dse_search_padded` / `dse_pareto_padded` launched at most once a
     scenario (the example's own count equal to the phase's);
     scenario_zoo `--full` on a cuda service, report equal to a numpy
     service's, the repeat sweep memoized in full; serve_photonic
     `--photonic`, 4 x 12 tokens and one `ddot_gemm_quantized` launch, the
     noise-free head `torch.equal` to its plain version on the card, the
     noisy rel_err inside the CPU tests' band, the report equal to the
     CPU run's. It prints each call's wall time and launches;
  9. prints one JSON line with every kernel's launches (counted per
     entry-point call, the counts set to 0 just before each call and read
     just after it), its largest difference from its plain version, its
     time, its plain version's time, its bound (bytes at the HBM rate, or
     operations: FLOPs at the published peaks for the LM kernels,
     instructions at the SM issue rate for the DSE kernels) and, where one
     PyTorch call computes the same function, that call's time; then the
     result line.

Phases 6, 6b, 6c and 8b pin the products' exec-safe mode
(`set_exec_safe(True)`: f32 operands), the mode their checks against the
CPU path and their stored figures were taken in, and print it; phase 8
runs its steps in both modes.

Any failed check raises, so the script exits non-zero and prints no result
line. It exits non-zero at once without a CUDA card, or outside a checkout.
"""
import contextlib
import copy
import dataclasses
import json
import math
import socket
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


def shard_phase(dev, n_z, hw, drive, inp):
    """Phase 4f: `shard=` on the DSE main path (ROADMAP item 8, DSE half).

    Prints k, the size of the candidate mesh `shard=4` gets here (one card:
    the public `shard=` clamps to k = 1, which still takes the sharded
    layout). Then, each held byte for byte (winners, float64 metrics,
    frontiers, every counter) to the same call at shard=None: the five
    paper workloads' 12^5 golden searches (`search_workloads`, cuda,
    hierarchical) in both objectives at shard=4 and at (shard=2,
    chunk_size=65536), also against the golden record; the n_z^5 BnB of
    deit-b in both objectives at shard=4 on the cuda and torch engines; a
    `SearchService(shard=4)`'s cold and warm query and its stats;
    `launch.serve dse --shard 4` and `launch.serve scenarios --shard 2`
    (their printed answers, less the wall times). Last, the ops-level
    launchers of kernels 2, 3, 5 and 6 given `(dev,) * 4` (the 12^5 grid
    of `inp`, `dse_inputs`' operands, and the n_z^5 span): the k = 4 layout
    on the one card, one launch a shard (4 in `LAUNCHES`), whose per-block
    columns, shard-local indices rebased, equal the unsharded launch's
    (`torch.equal`) and whose further columns are empty blocks. `drive` is
    phase 4c's, counting under the path "shard". Returns the wall times."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch
    from repro_torch.core import (Constraints, FactorizedSpace, search,
                                  search_workloads)
    from repro_torch.core.paper_workloads import PAPER_WORKLOADS, load
    from repro_torch.core.photonic_model import CONSTANTS
    from repro_torch.kernels import dse_eval as dse
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    from repro_torch.launch.mesh import make_candidate_mesh
    from repro_torch.serve import SearchService

    k = len(make_candidate_mesh(4, dev))
    print(f"shard: shard=4 spans k = {k} device(s) of "
          f"{torch.cuda.device_count()} ({hw})")
    names = sorted(PAPER_WORKLOADS)
    wls = {n: load(n) for n in names}
    cons = Constraints()
    space = FactorizedSpace.full(n_z)
    walls = []
    edp_keys = ("best_cfg", "area_mm2", "power_w", "energy_j", "latency_s",
                "edp")
    counts_keys = ("n_evaluated", "n_feasible", "n_workload_evals",
                   "n_pruned", "n_bounds")

    def same(got, want):
        if hasattr(want, "front"):
            return (np.array_equal(got.front, want.front)
                    and all(np.array_equal(got.metrics[m], want.metrics[m])
                            for m in want.metrics)
                    and got.n_overflow == want.n_overflow
                    and all(getattr(got, c) == getattr(want, c)
                            for c in counts_keys))
        return all(getattr(got, c) == getattr(want, c)
                   or getattr(want, c) != getattr(want, c)   # NaN: no winner
                   and getattr(got, c) != getattr(got, c)
                   for c in edp_keys + counts_keys)

    def golden_ok(r, n):
        gold = inp.golden["workloads"][n]
        if hasattr(r, "front"):
            return ([[int(x) for x in row] for row in r.front]
                    == gold["front"] and r.n_feasible == gold["n_feasible"])
        return ([int(x) for x in r.best_cfg.as_array()] == gold["best"]
                and r.edp == gold["edp"]
                and r.n_feasible == gold["n_feasible"])

    def pair(label, call, needs, shard_kw, check=None):
        """call(shard=None), then call(**shard_kw): the results equal, both
        walls printed; returns the sharded result."""
        want, t_base, _ = drive(f"{label} shard=None", lambda: call(),
                                needs)
        got, t_shard, counts = drive(f"{label} {shard_kw}",
                                     lambda: call(**shard_kw), needs)
        pairs = (list(zip(got.values(), want.values()))
                 if isinstance(got, dict) else [(got, want)])
        _check(all(same(g, w) for g, w in pairs),
               f"shard {label} {shard_kw}: differs from shard=None")
        if check is not None:
            check(got)
        walls.append((f"{label} {shard_kw}", t_shard, t_base))
        print(f"shard {label} {shard_kw}: equal to shard=None; "
              f"{t_shard:.4f} s vs {t_base:.4f} s ({hw}); launches "
              f"{ {n: c for n, c in counts.items() if c} }")
        return got

    # -- the 12^5 golden searches, both objectives ---------------------------
    for objective, needs in (("edp", ("dse_search_padded",)),
                             ("pareto", ("dse_pareto_padded",))):
        def golden_all(out):
            _check(all(golden_ok(out[n], n) for n in names),
                   f"shard 12^5 {objective}: differs from the golden record")

        for shard_kw in (dict(shard=4), dict(shard=2, chunk_size=65536)):
            pair(f"search_workloads 12^5 hierarchical {objective}",
                 lambda **kw: search_workloads(
                     wls, cons, engine="cuda", hierarchical=True,
                     objective=objective, device=dev, **kw),
                 needs, shard_kw, golden_all)

    # -- the n_z^5 BnB of deit-b, cuda and torch engines ----------------------
    for engine in ("cuda", "torch"):
        for objective in ("edp", "pareto"):
            needs = (() if engine == "torch" else ("dse_search_decoded",)
                     if objective == "edp" else ("dse_pareto_decoded",))
            pair(f"search {n_z}^5 prune=bound {objective} deit-b {engine}",
                 lambda **kw: search(
                     wls["deit-b"], cons, engine=engine, factorized=True,
                     space=space, prune="bound", objective=objective,
                     device=dev, **kw),
                 needs, dict(shard=4))

    # -- the service ---------------------------------------------------------
    one = SearchService(space=space, engine="cuda", device=dev)
    four = SearchService(space=space, engine="cuda", device=dev, shard=4)
    for label, box in (("cold", cons), ("warm", Constraints(power_w=4.5))):
        want, t_base, _ = drive(f"service {label} shard=None",
                                lambda: one.query(wls["deit-b"], box), ())
        got, t_shard, counts = drive(
            f"service {label} shard=4",
            lambda: four.query(wls["deit-b"], box),
            ("dse_search_decoded",) if label == "cold" else ())
        _check(same(got, want), f"shard service {label}: {got.best_cfg} vs "
                                f"{want.best_cfg}")
        walls.append((f"service {label} shard=4", t_shard, t_base))
        print(f"shard service {label}: equal to shard=None; {t_shard:.4f} s "
              f"vs {t_base:.4f} s ({hw})")
    _check(four.stats == one.stats,
           f"shard service stats {four.stats} vs {one.stats}")

    # -- the launcher ----------------------------------------------------------
    def printed(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            launch.main(argv)
        return re.sub(r"[0-9.]+ms", "ms", buf.getvalue())

    for argv, shard in ((["dse", "--workload", "all", "--n-z", "12",
                          "--scenario", "power_w=4.5"], "4"),
                        (["scenarios"], "2")):
        want, t_base, _ = drive(f"launch.serve {argv[0]}",
                                lambda: printed(argv), ())
        got, t_shard, _ = drive(f"launch.serve {argv[0]} --shard {shard}",
                                lambda: printed(argv + ["--shard", shard]),
                                ())
        _check(got == want, f"launch.serve {argv[0]} --shard {shard}: the "
                            f"printed answers differ from shard=None")
        walls.append((f"launch.serve {argv[0]} --shard {shard}", t_shard,
                      t_base))
        print(f"shard launch.serve {argv[0]} --shard {shard}: "
              f"{len(got.splitlines())} lines equal to shard=None's; "
              f"{t_shard:.4f} s vs {t_base:.4f} s ({hw})")

    # -- the k = 4 layout on one card: kernels 2, 3, 5 and 6 -----------------
    mesh4 = (dev,) * 4
    cons_np = ops._constraint_rows([cons])
    search_carry = ops._search_carry_rows(None, 1)
    front_carry = ops._front_carry_rows(None, 1, 3)
    objs = ("area", "power", "edp")

    def held(label, kernel, out4, base, idx_rows, col_base=None):
        """The k = 4 columns against the unsharded launch's `base`."""
        out4 = np.array(out4)
        if col_base is not None:
            idx = out4[idx_rows]
            out4[idx_rows] = np.where(idx >= 0, idx + col_base, idx)
        nb = base.shape[1]
        extra = out4[:, nb:]
        count_row = dse.SEARCH_ROWS - 1 if kernel.startswith("dse_search") \
            else 1
        _check(torch.equal(torch.from_numpy(out4[:, :nb]), base.cpu())
               and (extra[count_row] == 0).all()
               and (extra[idx_rows] < 0).all(),
               f"shard k=4 {label}: the rebased columns differ from the "
               f"unsharded launch")
        print(f"shard k=4 {label}: {out4.shape[1]} columns in 4 launches, "
              f"the first {nb} equal to the unsharded launch's, the rest "
              f"empty")

    def k4(label, kernel, fn):
        out, wall, counts = drive(f"k=4 {label}", fn, (kernel,))
        _check(counts[kernel] == 4, f"shard k=4 {label}: {counts[kernel]} "
                                    f"launches of {kernel}, not 4")
        walls.append((f"k=4 {label}", wall, None))
        return out

    out, ss, bps = k4("kernel 2 12^5 deit-b", "dse_search_padded",
                      lambda: ops._sharded_padded(
                          "search", inp.grid12, mesh4, inp.workloads,
                          CONSTANTS, cons_np, search_carry))
    base = dse.dse_search_padded(inp.cols, inp.mask, inp.cons_row, inp.carry,
                                 workloads=inp.workloads, constants=CONSTANTS)
    col_base = (np.arange(out.shape[1]) // bps) * ss
    held("kernel 2 12^5 deit-b", "dse_search_padded", out, base, [1],
         col_base)
    out, ss, bps = k4("kernel 5 12^5 deit-b", "dse_pareto_padded",
                      lambda: ops._sharded_padded(
                          "pareto", inp.grid12, mesh4, inp.workloads,
                          CONSTANTS, cons_np, front_carry, objs, False))
    base = dse.dse_pareto_padded(inp.cols, inp.mask, inp.cons_row,
                                 torch.from_numpy(front_carry).to(dev),
                                 workloads=inp.workloads, objectives=objs,
                                 has_carry=False, constants=CONSTANTS)
    col_base = (np.arange(out.shape[1]) // bps) * ss
    held("kernel 5 12^5 deit-b", "dse_pareto_padded", out, base,
         slice(dse.PARETO_HEADER, dse.PARETO_ROWS), col_base)
    for kind, kernel, carry_np, number in (
            ("search", "dse_search_decoded", search_carry, 3),
            ("pareto", "dse_pareto_decoded", front_carry, 6)):
        extra = dict(objectives=objs, has_carry=False) \
            if kind == "pareto" else {}
        out, _ = k4(f"kernel {number} {n_z}^5 span deit-b", kernel,
                    lambda: ops._decoded_launch(
                        space, 0, space.size, kind, inp.workloads, CONSTANTS,
                        cons_np, carry_np, dev, mesh=mesh4, **extra))
        base, _ = ops._decoded_launch(space, 0, space.size, kind,
                                      inp.workloads, CONSTANTS, cons_np,
                                      carry_np, dev, **extra)
        held(f"kernel {number} {n_z}^5 span deit-b", kernel, out,
             torch.from_numpy(base),
             [1] if kind == "search" else slice(dse.PARETO_HEADER,
                                                dse.PARETO_ROWS))
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


TRAIN_ARCHS = ("qwen2.5-3b", "llava-next-34b", "olmoe-1b-7b",
               "deepseek-v3-671b", "zamba2-7b", "rwkv6-7b",
               "seamless-m4t-medium", "gemma3-4b")
TRAIN_STEPS = 3
# Card against the port's CPU path over TRAIN_STEPS steps of a reduced
# model: the loss within the CPU tests' loss tolerance
# (tests/test_torch_train_grads.py's LOSS_ATOL: twice LOGIT_ATOL); the
# global gradient norm within TRAIN_GNORM_RTOL of the CPU path's, the
# tolerance each gradient leaf is held to against the reference (2^-5 of
# the leaf's largest magnitude), which bounds the norm's relative error too.
TRAIN_LOSS_ATOL = 2 * LOGIT_ATOL
TRAIN_GNORM_RTOL = 2.0 ** -5
# Published width: qwen2.5-3b at train_4k's sequence length, the global
# batch cut from 256 to 1 (the trainer has no gradient accumulation).
TRAIN_SEQ = 4096
TRAIN_BATCH = 1


def device_us(evt) -> float:
    """Self device time of a profiler average that is a device event (a
    kernel or a copy), in microseconds, under either of the attribute names
    PyTorch versions use; 0 for host events. An operator's average carries
    its kernels' device time too, so summing every row would count each
    kernel twice (the profiler's own table sums device events only)."""
    from torch.autograd import DeviceType
    if evt.device_type != DeviceType.CUDA \
            or getattr(evt, "is_user_annotation", False):
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


GEMM_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")


def device_split(prof, total_s: float) -> dict:
    """A profile's device seconds by kind: "f32 GEMM" (a GEMM operator
    whose kernels include an f32 one: cuBLAS's `sgemm` or `f32f32_f32f32`
    kernels; TF32 is off, so no f32 product runs on the tensor cores),
    "bf16 GEMM" (every other GEMM operator: bf16 operands on the tensor
    cores), "casts" (the copies of `aten::_to_copy`, i.e. dtype
    conversions) and "rest" (`total_s` less those). Each kernel counts under
    the operator that launched it (the profiler's correlation)."""
    split = {"f32 GEMM": 0.0, "bf16 GEMM": 0.0, "casts": 0.0}
    for e in prof.events():
        kernels = getattr(e, "kernels", None) or ()
        if not kernels or not e.name.startswith("aten::"):
            continue
        s_ = sum(k.duration for k in kernels) / 1e6
        if e.name in GEMM_OPS:
            f32 = any("sgemm" in k.name or "f32f32_f32f32" in k.name
                      for k in kernels)
            split["f32 GEMM" if f32 else "bf16 GEMM"] += s_
        elif e.name == "aten::copy_" and e.cpu_parent is not None \
                and e.cpu_parent.name == "aten::_to_copy":
            split["casts"] += s_
    split["rest"] = total_s - sum(split.values())
    return split


def _split_text(split: dict) -> str:
    return ", ".join(f"{k} {v:.3f} s" for k, v in split.items())


def train_phase(dev, hw, drive, counters):
    """Phase 6c: training on the card.

    (a) A reduced model of each of TRAIN_ARCHS (all seven families;
    gemma3-4b for the sliding window and tied embeddings), built on the
    CPU from a seeded generator and carried to the card: TRAIN_STEPS steps
    of `make_train_step` on the port's CPU path; each of them on the card
    from the CPU path's state before it (loss within TRAIN_LOSS_ATOL,
    grad_norm within TRAIN_GNORM_RTOL); the card's own TRAIN_STEPS steps
    from the same weights and pipeline batches (losses within
    TRAIN_LOSS_ATOL, all finite), run twice with a line saying whether
    their losses are bitwise equal (reported, not required). Along two
    trajectories the gradient norm is not comparable: AdamW turns a
    noise-level gradient (the reduced rwkv6-7b's bonus `u`, whose
    gradient norm falls from 3,300 to 60 in a step) into a full step of
    either sign, and a 0.1 % change of the weights moves the third step's
    norm by 30 % on the CPU alone.
    (b) `Trainer.run` for a reduced qwen2.5-3b: 4 steps with ckpt_every=2
    into a temporary directory, then a new `Trainer` that auto-resumes at
    step 4 (pipeline step 4) and runs 2 more, finite.
    (c) `python -m repro_torch.launch.train --arch granite-3-2b --reduced
    --steps 4` in-process.
    (e) the same with `--coordinator 127.0.0.1:<free port> --num-processes
    1 --process-id 0`: a one-rank NCCL group over `tcp://` on cuda:0, its
    losses within TRAIN_LOSS_ATOL of (c)'s (a line says whether they are
    bitwise equal), no process group left up after it.
    (d) qwen2.5-3b at its published width, AdamW with f32 moments, remat:
    3 steps of `make_train_step` at sequence TRAIN_SEQ, batch TRAIN_BATCH
    (each step's wall time and tokens/s, the peak device memory), one step
    under `torch.profiler` (device busy share, the kernels that take the
    most device time), then one step split into its forward and backward
    pass and its optimizer pass, each timed, and one forward pass without
    gradients (what remat runs a second time in the backward pass).
    Every call runs under `drive(label, fn, needs=())`; no hand-written
    kernel may launch. Returns the phase's summary."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import (Trainer, TrainerConfig, batch_to,
                                           make_train_step)

    def run(label, fn):
        out, wall = drive(label, fn, needs=())
        launched = {k: n for c in counters for k, n in c.items() if n}
        _check(not launched, f"{label}: launched {launched}; no reference "
                             f"model calls a kernel")
        return out, wall

    def cpu_built(cfg):
        return models.init_params(cfg, torch.Generator().manual_seed(1),
                                  "cpu")

    def on(device, model, state):
        """`model` moved to `device` with a copy of the optimizer state
        (the train step updates the moments in place)."""
        return model.to(device), adamw.OptState(
            state.step.to(device, copy=True),
            {n: t.to(device, copy=True) for n, t in state.mu.items()},
            {n: t.to(device, copy=True) for n, t in state.nu.items()})

    def trajectory(cfg, device, src, snapshots=None):
        """TRAIN_STEPS steps from the seeded CPU build, on `device`: the
        metrics of each step, and with `snapshots` (a list) the model and
        optimizer state each step started from, copied to the host."""
        model, state = on(device, cpu_built(cfg), adamw.init(
            opt_small, dict(cpu_built(cfg).named_parameters())))
        step = make_train_step(cfg, opt_small)
        rows = []
        for i in range(TRAIN_STEPS):
            if snapshots is not None:
                snapshots.append(on("cpu", copy.deepcopy(model), state))
            model, state, m = step(model, state,
                                   batch_to(src.batch_at(i), device))
            rows.append({k: float(v) for k, v in m.items()})
        return rows

    def steps_from(cfg, src, snapshots):
        """Each step on the card from the CPU path's state before it."""
        step = make_train_step(cfg, opt_small)
        rows = []
        for i, (model, state) in enumerate(snapshots):
            model, state = on(dev, copy.deepcopy(model), state)
            _, _, m = step(model, state, batch_to(src.batch_at(i), dev))
            rows.append({k: float(v) for k, v in m.items()})
        return rows

    t_phase = time.perf_counter()
    small_shape = ShapeConfig("tiny", 16, 2, "train")
    opt_small = adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                  total_steps=TRAIN_STEPS)
    for arch in TRAIN_ARCHS:
        cfg = reduced(get_config(arch))
        src = SyntheticTokenSource(cfg, small_shape, seed=0)
        snaps = []
        want = trajectory(cfg, torch.device("cpu"), src, snaps)
        each, _ = run(f"train reduced {arch} (each step from the CPU "
                      f"path's state)", lambda: steps_from(cfg, src, snaps))
        got, _ = run(f"train reduced {arch} ({TRAIN_STEPS} steps)",
                     lambda: trajectory(cfg, dev, src))
        again, _ = run(f"train reduced {arch} (again)",
                       lambda: trajectory(cfg, dev, src))
        _check(all(math.isfinite(v) for r in each + got + again
                   for v in r.values()),
               f"reduced {arch} training on the card: not finite")
        d_loss = max(abs(g["loss"] - w["loss"])
                     for g, w in zip(each + got, want + want))
        d_gn = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                   for g, w in zip(each, want))
        _check(d_loss <= TRAIN_LOSS_ATOL, f"reduced {arch} training: card "
               f"loss differs from the CPU path's by {d_loss!r} > "
               f"{TRAIN_LOSS_ATOL}")
        _check(d_gn <= TRAIN_GNORM_RTOL, f"reduced {arch} training: card "
               f"grad_norm differs from the CPU path's by {d_gn!r} "
               f"(relative) > {TRAIN_GNORM_RTOL}")
        free = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                   for g, w in zip(got, want))
        same = [g["loss"] for g in got] == [a["loss"] for a in again]
        print(f"train reduced {arch}: losses {[r['loss'] for r in got]}, "
              f"within {d_loss!r} of the CPU path's; grad_norm within "
              f"{d_gn!r} (relative) from the same state, {free!r} along "
              f"the card's own steps; two card runs bitwise equal: {same}")

    # (b) the fault-tolerant trainer: run, then auto-resume
    cfg = reduced(get_config("qwen2.5-3b"))
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainerConfig(total_steps=6, ckpt_every=2, ckpt_dir=d)
        shape = ShapeConfig("tiny", 32, 4, "train")
        first, _ = run("Trainer.run reduced qwen2.5-3b (4 steps)",
                       lambda: Trainer(cfg, shape, tcfg=tcfg,
                                       device=dev).run(num_steps=4))
        resumed = Trainer(cfg, shape, tcfg=tcfg, device=dev)
        _check(resumed.start_step == 4 and resumed.data.state.step == 4,
               f"Trainer resume: start step {resumed.start_step}, pipeline "
               f"step {resumed.data.state.step}, not 4")
        second, _ = run("Trainer.run reduced qwen2.5-3b (resumed, 2 steps)",
                        lambda: resumed.run(num_steps=2))
        _check(first["final_step"] == 4 and second["final_step"] == 6
               and all(math.isfinite(v) for v in second["losses"]),
               "Trainer resume: wrong final step or non-finite losses")
        print(f"Trainer reduced qwen2.5-3b: losses {first['losses']}, "
              f"resumed at step 4 (pipeline step 4): {second['losses']}")
    argv = ["--arch", "granite-3-2b", "--reduced", "--steps", "4"]
    with tempfile.TemporaryDirectory() as d:
        out, wall = run("launch.train granite-3-2b --reduced --steps 4",
                        lambda: launch_train.main([*argv, "--ckpt-dir", d]))
        _check(out["final_step"] == 4
               and all(math.isfinite(v) for v in out["losses"]),
               "launch.train: wrong final step or non-finite losses")
    print(f"launch.train granite-3-2b --reduced --steps 4: {wall:.2f} s")

    # (e) the same run as one NCCL rank of a --coordinator group
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    with tempfile.TemporaryDirectory() as d:
        coord, wall_c = run(
            "launch.train granite-3-2b --reduced --steps 4 --coordinator "
            "(one NCCL rank)",
            lambda: launch_train.main([
                *argv, "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", "1", "--process-id", "0",
                "--ckpt-dir", d]))
    _check(not dist.is_initialized(),
           "launch.train --coordinator left its process group up")
    d_loss = max(abs(a - b) for a, b in zip(coord["losses"], out["losses"]))
    _check(coord["final_step"] == 4 and d_loss <= TRAIN_LOSS_ATOL,
           f"launch.train --coordinator: final step {coord['final_step']}, "
           f"losses {coord['losses']} against the plain run's "
           f"{out['losses']} (within {TRAIN_LOSS_ATOL})")
    backend = "NCCL" if dev.type == "cuda" else "gloo"
    print(f"launch.train --coordinator, one {backend} rank on {dev} ({hw}): "
          f"{wall_c:.2f} s (plain {wall:.2f} s); losses {coord['losses']}, "
          f"within {d_loss!r} of the plain run's, bitwise equal: "
          f"{coord['losses'] == out['losses']}")

    # (d) qwen2.5-3b at its published width
    cfg = get_config("qwen2.5-3b")
    shape = ShapeConfig("train_4k_batch_1", TRAIN_SEQ, TRAIN_BATCH, "train")
    print(f"qwen2.5-3b training: train_4k's sequence {TRAIN_SEQ}, global "
          f"batch cut 256 -> {TRAIN_BATCH} (no gradient accumulation in "
          f"the trainer), AdamW f32 moments, remat")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = models.init_params(cfg, gen, device=dev)
    n_params = sum(p_.numel() for p_ in model.parameters())
    opt_cfg = adamw.AdamWConfig(moment_dtype=torch.float32)
    state = adamw.init(opt_cfg, dict(model.named_parameters()))
    step = make_train_step(cfg, opt_cfg, remat=True)
    src = SyntheticTokenSource(cfg, shape, seed=0)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    walls, losses, gnorms = [], [], []
    for i in range(TRAIN_STEPS):
        batch = batch_to(src.batch_at(i), dev)
        (model, state, m), wall = run(
            f"train qwen2.5-3b step {i + 1}",
            lambda: step(model, state, batch))
        m = {k: float(v) for k, v in m.items()}
        _check(all(math.isfinite(v) for v in m.values()),
               f"qwen2.5-3b training step {i + 1}: not finite ({m})")
        walls.append(wall)
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
        print(f"train qwen2.5-3b step {i + 1} ({hw}): {wall:.3f} s, "
              f"{tokens / wall:.1f} tokens/s, loss {m['loss']!r}, "
              f"grad_norm {m['grad_norm']!r}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"train qwen2.5-3b ({n_params} parameters) peak device memory: "
          f"{peak:.2f} GiB ({hw})")

    batch = batch_to(src.batch_at(TRAIN_STEPS), dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        model, state, _ = step(model, state, batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    dev_us = sum(device_us(e) for e in avgs)
    n_kernels = sum(e.count for e in avgs if device_us(e))
    busy = dev_us / 1e6 / prof_wall
    split = device_split(prof, dev_us / 1e6)
    print(f"train qwen2.5-3b profiled step ({hw}): wall {prof_wall:.3f} s, "
          f"device time {dev_us / 1e6:.3f} s, busy share {busy:.4f} "
          f"({dev_us / 1e6 / statistics.median(walls):.4f} of the median "
          f"unprofiled step), {n_kernels} kernels; device time by kind: "
          f"{_split_text(split)}")
    for e in sorted(avgs, key=device_us, reverse=True)[:12]:
        if device_us(e):
            print(f"  device {device_us(e) / 1e3:10.2f} ms  x{e.count:<6d} "
                  f"{e.key[:90]}")

    # one step split: forward + backward (remat), then the optimizer pass
    named = dict(model.named_parameters())
    batch = batch_to(src.batch_at(TRAIN_STEPS + 1), dev)

    def fwd_bwd():
        loss, _ = models.lm_loss(model, cfg, batch, remat=True)
        loss.backward()
        return loss
    with torch.no_grad():
        _, t_f = run("train qwen2.5-3b forward (no gradient)",
                     lambda: models.lm_loss(model, cfg, batch, remat=False))
    _, t_fb = run("train qwen2.5-3b forward + backward", fwd_bwd)
    (_, state, _), t_opt = run(
        "train qwen2.5-3b AdamW pass",
        lambda: adamw.apply(opt_cfg, named,
                            {n: p_.grad for n, p_ in named.items()}, state,
                            model_cfg=cfg))
    print(f"train qwen2.5-3b step split ({hw}): forward alone {t_f:.3f} "
          f"s (what remat runs twice), forward + backward {t_fb:.3f} s, "
          f"AdamW over {len(named)} tensors {t_opt:.3f} s")
    del model, state, named, batch, prof, avgs
    torch.cuda.empty_cache()
    summary = {"step_s": walls, "tokens_per_s": [tokens / w for w in walls],
               "peak_gib": peak, "busy": busy, "fwd_s": t_f,
               "fwd_bwd_s": t_fb, "adamw_s": t_opt, "losses": losses,
               "grad_norms": gnorms, "device_s": dev_us / 1e6,
               "split": split}
    print(f"phase 6c wall time: {time.perf_counter() - t_phase:.1f} s ({hw})")
    return summary


@contextlib.contextmanager
def product_mode(exec_safe: bool, label: str, hw: str):
    """Run a phase with the products' mode set (`models.layers.
    set_exec_safe`), printing it, and restore the mode after it. The
    phases that hold the card against the CPU path or a stored figure pin
    exec-safe (f32 operands), the mode their records were taken in."""
    from repro_torch.models import layers
    prev = layers._EXEC_SAFE
    layers.set_exec_safe(exec_safe)
    print(f"{label}: products "
          + ("exec-safe (f32 operands)" if exec_safe
             else "bf16 operands, f32 result") + f" ({hw})")
    try:
        yield
    finally:
        layers.set_exec_safe(prev)


def leaf_grads(model, cfg, batch) -> dict:
    """The gradients of `models.lm_loss` (remat, as the train step runs
    it) by parameter name; the weights are left as they were."""
    import torch

    import repro_torch.models as models

    named = dict(model.named_parameters())
    model.requires_grad_(True)
    try:
        loss, _ = models.lm_loss(model, cfg, batch, remat=True)
        gs = torch.autograd.grad(loss, list(named.values()),
                                 allow_unused=True)
    finally:
        model.requires_grad_(False)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(named.items(), gs)}


def bf16_result_reduction(dev, hw, run):
    """Phase 6d(e): rwkv6-7b at its published width cut to two layers, one
    `lm_loss` forward and backward (remat) on 1 x 64 tokens with PyTorch's
    default `allow_bf16_reduced_precision_reduction` (True) set around it.
    Every GEMM with a bf16 result (the time and channel mixes' plain
    `x @ w`, `layers.matmul16`) must run with the flag off, in the forward,
    its recompute and the backward (at least three times the GEMMs of a
    forward alone), and the flag must be True again after."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import repro_torch.models as models
    from repro_torch.configs import get_config

    aten = torch.ops.aten
    gemms = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
    flags = torch.backends.cuda.matmul

    class Seen(TorchDispatchMode):
        """bf16-result GEMMs by the flag's value when each ran."""

        def __init__(self):
            super().__init__()
            self.n = {True: 0, False: 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket in gemms \
                    and out.dtype == torch.bfloat16:
                self.n[bool(
                    flags.allow_bf16_reduced_precision_reduction)] += 1
            return out

    cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=2)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = models.init_params(cfg, gen, device=dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, 64), generator=gen,
                                     device=dev, dtype=torch.int32)}
    fwd, both = Seen(), Seen()

    def forward():
        with fwd, torch.no_grad():
            models.forward(model, cfg, batch)

    def fwd_bwd():
        model.requires_grad_(True)
        with both:
            loss, _ = models.lm_loss(model, cfg, batch, remat=True)
            loss.backward()
        return float(loss.detach())

    prev = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = True
    try:
        run("rwkv6-7b two layers, forward", forward)
        loss, wall = run("rwkv6-7b two layers, forward and backward",
                         fwd_bwd)
        after = flags.allow_bf16_reduced_precision_reduction
    finally:
        flags.allow_bf16_reduced_precision_reduction = prev
        model.requires_grad_(False)
    del model
    torch.cuda.empty_cache()
    print(f"rwkv6-7b cut to 2 layers, 1 x 64 tokens ({hw}): bf16-result "
          f"GEMMs under allow_bf16_reduced_precision_reduction False / "
          f"True: forward {fwd.n[False]} / {fwd.n[True]}, forward and "
          f"backward {both.n[False]} / {both.n[True]} ({wall:.2f} s, loss "
          f"{loss!r}); the flag after: {after}")
    _check(fwd.n[False] > 0 and fwd.n[True] == 0 and both.n[True] == 0
           and both.n[False] >= 3 * fwd.n[False] and after,
           f"rwkv6-7b bf16-result GEMMs: forward {fwd.n}, forward and "
           f"backward {both.n}, the flag after {after}")


def precision_shapes(cfg):
    """Phase 6d's operands per equation: qwen2.5-3b's widths at batch 4,
    sequence 128 (the LM head at its whole vocabulary); the MLA equations
    at deepseek-v3's latent rank 512 with qwen2.5-3b's 16 heads of 128; the
    MoE equations on a sort-dispatch buffer of 8 experts x 128 slots at
    qwen2.5-3b's d_model and d_ff. Returns ({equation: (shape a, shape
    b)}, matmul32's (shape a, shape b))."""
    b, s, d, f = 4, 128, cfg.d_model, cfg.d_ff
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g, v, r, e, c = h // hkv, cfg.vocab, 512, 8, 128
    return {
        "bsd,dhk->bshk": ((b, s, d), (d, h, dh)),
        "bshk,hkd->bsd": ((b, s, h, dh), (h, dh, d)),
        "bsr,rhk->bshk": ((b, s, r), (r, h, dh)),
        "bsd,vd->bsv": ((b, s, d), (v, d)),
        "bqhd,bkhd->bhqk": ((b, s, h, dh), (b, s, h, dh)),
        "bhqk,bkhd->bqhd": ((b, h, s, s), (b, s, h, dh)),
        "bqhgd,bkhd->bhgqk": ((b, s, hkv, g, dh), (b, s, hkv, dh)),
        "bhgqk,bkhd->bqhgd": ((b, hkv, g, s, s), (b, s, hkv, dh)),
        "bqhd,hdm->bqm": ((b, s, h, dh), (h, dh, d)),
        "bqhn,bkhn->bhqk": ((b, s, h, dh), (b, s, h, dh)),
        "bqhn,rhn->bqhr": ((b, s, h, dh), (r, h, dh)),
        "bqhr,bkr->bhqk": ((b, s, h, r), (b, s, r)),
        "bhqk,bkr->bqhr": ((b, h, s, s), (b, s, r)),
        "bqhr,rhd->bqhd": ((b, s, h, r), (r, h, dh)),
        "...ecd,edf->...ecf": ((e, c, d), (e, d, f)),
        "...ecf,efd->...ecd": ((e, c, f), (e, f, d)),
    }, ((b, s, d), (d, f))


# Greedy tokens of the two product modes must be equal wherever the
# exec-safe run's top-2 logit margin exceeds twice LOGIT_ATOL
# (tests/test_torch_lm.py's rule).
MARGIN = 2 * LOGIT_ATOL


def precision_phase(dev, hw, drive, counters, train):
    """Phase 6d: the products' bf16 mode (`set_exec_safe(False)`, the
    reference's default) on the card, beside exec-safe; the mode is
    restored after the phase.

    (a) Each of the models' 16 einsum equations and `matmul32` at
    `precision_shapes`, in bf16 mode (the library's bf16 x bf16 -> f32
    product) against the exec-safe f32 product of the same operands on the
    card: the largest |diff| / (K 2^-24 sum|a b|) must be at most 1 (two f32
    sums of the same exact products, each within that of the exact sum);
    every call counted under `PRODUCTS["bf16"]`; the share of results that
    are bf16 values (1 would mean a bf16-rounded result) and the times of
    the bf16 route, the exec-safe route and the bf16-result library product
    (`torch.einsum` of the bf16 operands, a yardstick the port never
    calls).
    (b) Phase 6c's qwen2.5-3b step in bf16 mode: the same weights (seed 0)
    and batches, TRAIN_STEPS timed steps and one profiled step (busy share,
    the device-time split of `device_split`), the peak device memory; each
    step's loss within TRAIN_LOSS_ATOL and gradient norm within
    TRAIN_GNORM_RTOL of phase 6c's (steps 2 and 3 start from weights the
    backward and AdamW updated), the first step's gradients leaf by leaf
    (`leaf_grads`, both modes on the same weights and batch) within
    TRAIN_GNORM_RTOL of the exec-safe ones in norm, and no product in f32
    (`PRODUCTS["f32"] == 0`). The exec-safe step figures printed beside
    them are phase 6c's, from this run.
    (c) `Server.generate`, 4 x 12 tokens of the full-width qwen2.5-3b, in
    each mode (a first and a timed second call): ttft, decode s/token,
    peak; the greedy tokens equal wherever the exec-safe run's top-2 margin
    exceeds MARGIN (a row may part only at a step within it, and stops
    there).
    (d) `launch.serve tokens --arch qwen2.5-3b` through its `main` at full
    width: every product on the bf16 route.
    (e) `bf16_result_reduction`: rwkv6-7b's bf16-result GEMMs, forward and
    backward, run with cuBLAS's bf16 reduced-precision reduction off.
    Every call runs under `drive(label, fn, needs=())`; no hand-written
    kernel may launch. Returns the phase's summary."""
    import numpy as np
    import torch

    import repro_torch.models as models
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import layers
    from repro_torch.optim import adamw
    from repro_torch.train.serve import Request, Server
    from repro_torch.train.trainer import batch_to, make_train_step

    def run(label, fn):
        out, wall = drive(label, fn, needs=())
        launched = {k: n for c in counters for k, n in c.items() if n}
        _check(not launched, f"{label}: launched {launched}; no reference "
                             f"model calls a kernel")
        return out, wall

    def count_products():
        layers.PRODUCTS.update(bf16=0, f32=0, f32_lowered=0)

    t_phase = time.perf_counter()
    cfg = get_config("qwen2.5-3b")
    summary = {}
    with product_mode(False, "phase 6d", hw):
        # (a) the products, each against the f32 product on the card
        eqs, mm_shapes = precision_shapes(cfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(5)
        count_products()
        worst = 0.0
        for eq, shapes in list(eqs.items()) + [("matmul32", mm_shapes)]:
            a, b = (torch.randn(s_, generator=gen, device=dev)
                    .to(torch.bfloat16) for s_ in shapes)
            if eq == "matmul32":
                got = layers.matmul32(a, b)
                want, k = a.float() @ b.float(), a.shape[-1]
                abs_sum = a.float().abs() @ b.float().abs()
                fns = (lambda: layers.lowered_einsum("...k,kn->...n", a, b),
                       lambda: a.float() @ b.float(), lambda: a @ b)
            else:
                got = layers.einsum32(eq, a, b)
                want = torch.einsum(eq, a.float(), b.float())
                abs_sum = torch.einsum(eq, a.float().abs(), b.float().abs())
                k = layers._plan(eq, tuple(a.shape), tuple(b.shape)) \
                    .shape_a3[-1]
                fns = (lambda: layers.lowered_einsum(eq, a, b),
                       lambda: torch.einsum(eq, a.float(), b.float()),
                       lambda: torch.einsum(eq, a, b))
            _check(got.dtype == torch.float32 and got.shape == want.shape,
                   f"{eq}: bf16 route gave {got.dtype} {tuple(got.shape)}")
            bound = k * 2.0 ** -24 * abs_sum
            diff = (got - want).abs()
            ratio = float(torch.where(
                bound > 0, diff / torch.where(bound > 0, bound, 1.0),
                torch.where(diff == 0, 0.0, math.inf)).max())
            bf16_share = float((got.bfloat16().float() == got).float()
                               .mean())
            t_b, t_f, t_l = (_time_ms(f_, reps=3, inner=3) for f_ in fns)
            worst = max(worst, ratio)
            print(f"product {eq} {tuple(a.shape)} x {tuple(b.shape)} "
                  f"(K {k}, {hw}): largest |diff| / (K 2^-24 sum|ab|) "
                  f"{ratio:.4g}, results that are bf16 values {bf16_share:.4f}"
                  f"; bf16 route {t_b:.4f} ms, exec-safe {t_f:.4f} ms, "
                  f"bf16-result library product {t_l:.4f} ms")
            _check(ratio <= 1.0, f"{eq}: the bf16 route is {ratio!r} times "
                                 f"the summation-order bound from the f32 "
                                 f"product")
            del a, b, got, want, abs_sum, bound, diff
        n_checked = len(eqs) + 1
        _check(layers.PRODUCTS == {"bf16": n_checked, "f32": 0,
                                   "f32_lowered": 0},
               f"phase 6d products: routes {layers.PRODUCTS}, not "
               f"{n_checked} bf16")
        print(f"phase 6d products: {n_checked} checked within the bound "
              f"(largest {worst:.4g}), routes {layers.PRODUCTS}")
        summary["worst_ratio"] = worst
        torch.cuda.empty_cache()

        # (b) phase 6c's qwen2.5-3b step in bf16 mode
        shape = ShapeConfig("train_4k_batch_1", TRAIN_SEQ, TRAIN_BATCH,
                            "train")
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = models.init_params(cfg, gen, device=dev)
        opt_cfg = adamw.AdamWConfig(moment_dtype=torch.float32)
        state = adamw.init(opt_cfg, dict(model.named_parameters()))
        step = make_train_step(cfg, opt_cfg, remat=True)
        src = SyntheticTokenSource(cfg, shape, seed=0)
        tokens = TRAIN_SEQ * TRAIN_BATCH
        # the backward: step 1's gradients, leaf by leaf, in both modes
        batch = batch_to(src.batch_at(0), dev)
        grads = {}
        for exec_safe in (True, False):
            layers.set_exec_safe(exec_safe)
            grads[exec_safe], _ = run(
                f"qwen2.5-3b gradients, exec-safe {exec_safe}",
                lambda: leaf_grads(model, cfg, batch))
        rel = {n_: float((g_ - grads[True][n_]).norm()
                         / grads[True][n_].norm().clamp_min(1e-30))
               for n_, g_ in grads[False].items()}
        worst_leaf = max(rel, key=rel.get)
        del grads, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(f"qwen2.5-3b step-1 gradients, bf16 against exec-safe ({hw}): "
              f"{len(rel)} leaves, largest |g_bf16 - g_exec_safe| / "
              f"|g_exec_safe| {rel[worst_leaf]:.4g} ({worst_leaf}), median "
              f"{statistics.median(rel.values()):.4g}")
        _check(rel[worst_leaf] <= TRAIN_GNORM_RTOL,
               f"qwen2.5-3b gradients: leaf {worst_leaf} is "
               f"{rel[worst_leaf]!r} from exec-safe, above "
               f"{TRAIN_GNORM_RTOL}")
        count_products()
        walls, losses, gnorms = [], [], []
        for i in range(TRAIN_STEPS):
            batch = batch_to(src.batch_at(i), dev)
            (model, state, m), wall = run(
                f"train qwen2.5-3b bf16 products step {i + 1}",
                lambda: step(model, state, batch))
            m = {k_: float(v_) for k_, v_ in m.items()}
            _check(all(math.isfinite(v_) for v_ in m.values()),
                   f"qwen2.5-3b bf16 step {i + 1}: not finite ({m})")
            walls.append(wall)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        batch = batch_to(src.batch_at(TRAIN_STEPS), dev)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            model, state, _ = step(model, state, batch)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        avgs = prof.key_averages()
        dev_s = sum(device_us(e) for e in avgs) / 1e6
        split = device_split(prof, dev_s)
        routes = dict(layers.PRODUCTS)
        del model, state, batch, prof, avgs
        torch.cuda.empty_cache()
        d_loss = max(abs(a_ - b_) for a_, b_ in zip(losses,
                                                     train["losses"]))
        d_gnorm = max(abs(a_ - b_) / b_ for a_, b_ in zip(
            gnorms, train["grad_norms"]))
        _check(routes["f32"] == 0 and routes["bf16"] > 0,
               f"qwen2.5-3b bf16 steps: product routes {routes}")
        # steps 2 and on run from weights the backward and AdamW updated
        _check(d_loss <= TRAIN_LOSS_ATOL, f"qwen2.5-3b steps: bf16 losses "
               f"{losses} against exec-safe {train['losses']}")
        _check(d_gnorm <= TRAIN_GNORM_RTOL, f"qwen2.5-3b steps: bf16 "
               f"gradient norms {gnorms} against exec-safe "
               f"{train['grad_norms']}")
        med = statistics.median(walls)
        med_es = statistics.median(train["step_s"])
        print(f"train qwen2.5-3b, bf16 products ({hw}): steps "
              + ", ".join(f"{w_:.3f}" for w_ in walls) + " s, "
              + ", ".join(f"{tokens / w_:.1f}" for w_ in walls)
              + f" tokens/s, peak {peak:.2f} GiB, losses {losses}, "
              f"gradient norms {gnorms}; "
              f"profiled step wall {prof_wall:.3f} s, device {dev_s:.3f} s, "
              f"busy {dev_s / prof_wall:.4f}; by kind: {_split_text(split)}; "
              f"product routes {routes}")
        print(f"train qwen2.5-3b, exec-safe products (phase 6c, {hw}): "
              f"steps " + ", ".join(f"{w_:.3f}" for w_ in train["step_s"])
              + " s, " + ", ".join(f"{r_:.1f}" for r_ in
                                   train["tokens_per_s"])
              + f" tokens/s, peak {train['peak_gib']:.2f} GiB, losses "
              f"{train['losses']}, gradient norms {train['grad_norms']}; "
              f"device {train['device_s']:.3f} s, busy "
              f"{train['busy']:.4f}; by kind: {_split_text(train['split'])}")
        print(f"train qwen2.5-3b step, bf16 against exec-safe ({hw}): median "
              f"{med:.3f} / {med_es:.3f} s ({med / med_es:.3f}x), losses "
              f"within {d_loss!r}, gradient norms within {d_gnorm!r} "
              f"relative")
        summary["train"] = {"step_s": walls, "peak_gib": peak,
                            "busy": dev_s / prof_wall, "device_s": dev_s,
                            "split": split, "losses": losses}

        # (c) serving in each mode
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = models.init_params(cfg, gen, device=dev)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab, size=rng.integers(4, 12))
                   .astype(np.int32) for _ in range(4)]
        srv = Server(cfg, params, batch_size=4, max_len=64, device=dev)
        served = {}
        for exec_safe in (True, False):
            layers.set_exec_safe(exec_safe)
            mode = "exec-safe" if exec_safe else "bf16"
            torch.cuda.reset_peak_memory_stats()
            count_products()
            for call in ("first", "second"):
                reqs = [Request(prompt=p_, max_new=12) for p_ in prompts]
                stats, _ = run(f"serve qwen2.5-3b 4x12 {mode} ({call})",
                               lambda: srv.generate(reqs))
            routes = dict(layers.PRODUCTS)
            _check(routes["f32" if not exec_safe else "bf16"] == 0,
                   f"serving in {mode} mode: product routes {routes}")
            served[mode] = {"stats": stats, "peak_gib":
                            torch.cuda.max_memory_allocated() / 2**30,
                            "tokens": [r_.out for r_ in reqs]}
            print(f"serve qwen2.5-3b 4x12, {mode} products ({hw}): ttft "
                  f"{stats['ttft_s']:.4f} s, decode "
                  f"{stats['decode_s_per_tok']:.4f} s/token, peak "
                  f"{served[mode]['peak_gib']:.2f} GiB, product routes "
                  f"{routes}")
        # the exec-safe run's margins: one more run, each step's logits kept
        layers.set_exec_safe(True)
        margins, orig = [], (models.prefill, models.decode_step)

        def keep(fn):
            def wrapped(*a_, **kw_):
                out = fn(*a_, **kw_)
                top2 = torch.topk(out[0].float(), 2, dim=-1).values
                margins.append((top2[:, 0] - top2[:, 1]).tolist())
                return out
            return wrapped
        models.prefill, models.decode_step = keep(orig[0]), keep(orig[1])
        try:
            reqs = [Request(prompt=p_, max_new=12) for p_ in prompts]
            srv.generate(reqs)
        finally:
            models.prefill, models.decode_step = orig
        layers.set_exec_safe(False)
        traced = [r_.out for r_ in reqs]
        _check(traced == served["exec-safe"]["tokens"],
               "serving exec-safe: the traced run's tokens differ")
        same = parted = 0
        for i, (want, got) in enumerate(zip(traced,
                                            served["bf16"]["tokens"])):
            for j, (w_, g_) in enumerate(zip(want, got)):
                if w_ != g_:
                    _check(margins[j][i] <= MARGIN, f"serving bf16: request "
                           f"{i} step {j} differs from exec-safe where its "
                           f"top-2 margin is {margins[j][i]!r} > {MARGIN}")
                    parted += 1
                    break
                same += 1
        print(f"serve qwen2.5-3b greedy tokens, bf16 against exec-safe "
              f"({hw}): {same} of 48 equal before any parting, {parted} "
              f"requests parted at a step whose margin is within {MARGIN}")
        summary["serve"] = served
        del srv, params
        torch.cuda.empty_cache()

        # (d) the launcher at full width
        count_products()
        _, wall = run("launch.serve tokens --arch qwen2.5-3b",
                      lambda: launch_serve.main(["tokens", "--arch",
                                                 "qwen2.5-3b"]))
        routes = dict(layers.PRODUCTS)
        _check(routes["f32"] == 0 and routes["bf16"] > 0,
               f"launch.serve tokens at full width: product routes {routes}")
        print(f"launch.serve tokens --arch qwen2.5-3b ({hw}): {wall:.2f} s, "
              f"product routes {routes}")
        torch.cuda.empty_cache()

        # (e) bf16-result GEMMs reduce in f32
        bf16_result_reduction(dev, hw, run)
    print(f"phase 6d wall time: {time.perf_counter() - t_phase:.1f} s ({hw})")
    return summary


DRYRUN_CELLS = (("granite-3-2b", "decode_32k", "single"),
                ("h2o-danube-1.8b", "train_4k", "multi"),
                ("qwen2.5-3b", "long_500k", "single"),
                ("rwkv6-7b", "long_500k", "single"),
                ("qwen2.5-3b", "decode_32k", "single"))
# qwen2.5-3b decode_32k single's all-gather bytes a card, at most: the
# embedding table's vocabulary-sharded gather (0.62 GB) and the decode
# queries; a gather of the sequence-sharded cache would add ~19 GB.
QWEN_DECODE_ALL_GATHER_MAX = 0.7e9
# Phase 8(d)'s shapes (tests/test_torch_seq_sharded_decode.py's): batch,
# cache length, query and K/V heads, head dimension, the written row.
SEQ_SHAPES = (8, 4096, 16, 2, 128, 17)
# The collective bytes GSPMD gives the reference's programs at those
# shapes on a (1, 4) mesh (that test's reference subprocess, XLA on four
# CPU devices): all-reduces of the softmax's max and sum and of the f32
# output; no collective for the row write; the same at twice the length.
GSPMD_DECODE_BYTES = {"attend": {"all-reduce": 66560},
                      "write": {},
                      "mla": {"all-reduce": 8704}}


# Phase 8(e)'s blocks (tests/test_torch_seq_parallel_products.py's): the
# reduced arch, batch and sequence, and the mesh of each rule set.
SEQ_PARALLEL_SHAPES = ("gemma3-4b", 4, 256)
SEQ_PARALLEL_MESHES = {"prefill": (1, 4), "train": (2, 2)}
# The attention block of reduced qwen2.5-3b too (one KV head: "model"
# moves onto K/V's head_dim), in both GQA modes, and the reduction bytes
# GSPMD gives the reference's in a train step on (2, 2) (that test's
# reference subprocess, XLA on four CPU devices: f32 all-reduces, the same
# in both GQA modes and both product modes).
SEQ_PARALLEL_KV_ON_HEAD_DIM = "qwen2.5-3b"
GSPMD_QWEN_TRAIN_REDUCTION_BYTES = 1065600


def _gib(n: float) -> str:
    return f"{n / 2**30:.3f} GiB"


# The bf16 route's products as `parallel.sharding.GATHERED` names them.
PRODUCT_OPS = ("aten.mm.dtype", "aten.bmm.dtype")
# The views, as `GATHERED` names them, that phases 8(d) and 8(e) must not
# retry on gathered operands (`parallel.sharding.StridedViews`).
VIEW_OPS = ("aten.view.default", "aten._unsafe_view.default",
            "aten.reshape.default")
# GEMM FLOPs of phase 6c's qwen2.5-3b step (seq 4096, batch 1, remat), as
# the exec-safe step counts them; bf16 mode runs the same products.
QWEN_STEP_GEMM_FLOPS = 111_705_656_918_016


def one_card_rules(dev, hw, run, cfg):
    """Phase 8(c): `cfg` with DTensor parameters from `param_specs` on a
    one-card mesh over a real NCCL group of one rank (a FileStore, no
    network): its prefill logits, and a decode step's logits and cache from
    the prefill's cache, bit-equal to the NULL_RULES ones, in exec-safe
    mode and in bf16 mode (in bf16 mode every product on the bf16 route
    and none gathered); then `bf16_on_dtensor`. `run(label, fn)` drives
    `fn` and fails if a kernel launched."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import models
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.specs import (cache_specs, distribute_params,
                                            distribute_tensors, param_specs)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(Path(tmp) / "store"), 1), rank=0, world_size=1)
        try:
            def one_card():
                from torch.distributed.tensor import DTensor

                def full(t):
                    return t.full_tensor() if isinstance(t, DTensor) else t

                mesh1 = make_host_mesh("cuda")
                plain = models.init_params(
                    cfg, torch.Generator(device=dev).manual_seed(0),
                    device=dev)
                toks = torch.randint(0, cfg.vocab, (4, 24), device=dev,
                                     generator=torch.Generator(
                                         device=dev).manual_seed(1),
                                     dtype=torch.int32)
                same, n_dt = {}, {}
                shd.GATHERED.clear()
                layers.PRODUCTS.update(bf16=0, f32=0, f32_lowered=0)
                with torch.no_grad():
                    want, cache = models.prefill(plain, cfg,
                                                 {"tokens": toks})
                    cache = {k: torch.nn.functional.pad(
                        v, (0, 0) * (v.ndim - 3) + (0, 4))
                        for k, v in cache.items()}
                    for kind, rs in (("prefill", shd.PREFILL_RULES),
                                     ("decode", shd.DECODE_RULES)):
                        rules = shd.for_mesh(rs, mesh1)
                        sharded = distribute_params(
                            copy.deepcopy(plain),
                            param_specs(cfg, rules, plain), mesh1)
                        n_dt[kind] = sum(isinstance(p, DTensor)
                                         for p in sharded.parameters())
                        if kind == "prefill":
                            got, _ = models.prefill(sharded, cfg,
                                                    {"tokens": toks},
                                                    rules=rules)
                            same[kind] = torch.equal(want, full(got))
                        else:
                            c = distribute_tensors(
                                {k: v.clone() for k, v in cache.items()},
                                cache_specs(cfg, rules), mesh1)
                            got, c = models.decode_step(
                                sharded, cfg, toks[:, :1], 24, c,
                                rules=rules)
                            want_d, cache = models.decode_step(
                                plain, cfg, toks[:, :1], 24, cache)
                            same[kind] = torch.equal(want_d, full(got))
                            same["cache"] = all(torch.equal(
                                cache[k], full(c[k])) for k in cache)
                        del sharded, got
                        torch.cuda.empty_cache()
                return (same, dict(shd.GATHERED), n_dt,
                        dict(layers.PRODUCTS))
            for exec_safe in (True, False):
                mode = "exec-safe" if exec_safe else "bf16"
                with product_mode(exec_safe, f"phase 8(c) {mode}", hw):
                    (same, gathered, n_dt, routes), _ = run(
                        f"one-card DTensor prefill and decode, {mode}",
                        one_card)
                print(f"one-card mesh (NCCL, 1 rank, {hw}), {mode} "
                      f"products: qwen2.5-3b at its published width, 4 x "
                      f"24 tokens, {n_dt['prefill']} DTensor parameters: "
                      f"prefill logits bit-equal to NULL_RULES: "
                      f"{same['prefill']}; decode step logits: "
                      f"{same['decode']}, cache: {same['cache']} (ops "
                      f"gathered: {gathered}; product routes {routes})")
                _check(all(same.values()), f"one-card DTensor run "
                                           f"({mode}) differs from "
                                           f"NULL_RULES: {same}")
                if not exec_safe:
                    _bf16_routes_held(dev, "one-card DTensor prefill and "
                                      "decode", routes, gathered)
            bf16_on_dtensor(dev, hw, run, cfg, tmp)
        finally:
            dist.destroy_process_group()


def _bf16_routes_held(dev, label, routes, gathered):
    """On a card in bf16 mode: no product took f32 operands, one took the
    bf16 route, and no product was gathered (`GATHERED`)."""
    if dev.type != "cuda":
        return
    _check(routes["f32"] == 0 and routes["bf16"] > 0,
           f"{label}: product routes {routes} in bf16 mode")
    _check(not set(gathered) & set(PRODUCT_OPS),
           f"{label}: DTensor gathered a product's operands: {gathered}")


def bf16_on_dtensor(dev, hw, run, cfg, tmp):
    """Phase 8(c) in bf16 mode, the reference's default, on the one-card
    mesh of the process group the caller holds: the library's f32-result
    products (`aten.mm.dtype` / `aten.bmm.dtype`) called bare on DTensors
    propagate, equal to the plain product; one train step of `cfg` (loss,
    gradient norm, every updated parameter) and two `Trainer(shardings=)`
    steps of `cfg` cut to one layer (its checkpoints, under `tmp`, hold the
    whole moments) on DTensor parameters are bit-equal to the plain bf16
    run on the same weights and tokens, with every product on the bf16
    route and none gathered. The mode is restored."""
    import torch
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from repro_torch import models
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.specs import distribute_params, param_specs
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           make_train_step)

    mesh1 = make_host_mesh("cuda" if dev.type == "cuda" else "cpu")
    toks = torch.randint(0, cfg.vocab, (4, 24), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1),
                         dtype=torch.int32)

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def bare():
        gen = torch.Generator(device=dev).manual_seed(2)
        a = torch.randn((2, 8, 16), generator=gen, device=dev).bfloat16()
        b = torch.randn((2, 16, 12), generator=gen, device=dev).bfloat16()
        rep = [Replicate()] * mesh1.ndim
        a_d = distribute_tensor(a, mesh1, rep)
        b_d = distribute_tensor(b, mesh1, [Shard(2)] * mesh1.ndim)
        f32 = torch.float32
        if dev.type != "cuda":          # no CPU kernel: the rehearsal
            return {}
        return {"mm.dtype": torch.equal(
                    full(torch.mm(a_d[0], b_d[0], out_dtype=f32)),
                    torch.mm(a[0], b[0], out_dtype=f32)),
                "bmm.dtype": torch.equal(
                    full(torch.bmm(a_d, b_d, out_dtype=f32)),
                    torch.bmm(a, b, out_dtype=f32))}

    def train_once(rules):
        model = models.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        if rules is not shd.NULL_RULES:
            distribute_params(model, param_specs(cfg, rules, model), mesh1)
        opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
        state = adamw.init(opt_cfg, dict(model.named_parameters()))
        _, _, m = make_train_step(cfg, opt_cfg, rules)(
            model, state, {"tokens": toks})
        del state
        return [full(m["loss"]), full(m["grad_norm"])] + [
            full(p).detach() for p in model.parameters()]

    cfg1 = dataclasses.replace(cfg, n_layers=1)

    def trainer_once(rules, shardings, name):
        t = Trainer(cfg1, ShapeConfig("train_24", 24, 4, "train"),
                    tcfg=TrainerConfig(total_steps=2, ckpt_every=2,
                                       ckpt_dir=str(Path(tmp) / name)),
                    rules=rules, shardings=shardings, device=dev)
        out = t.run()
        return [torch.tensor(out["losses"])] + [
            full(p).detach() for p in t.state["params"].parameters()]

    def same(want, got):
        return len(want) == len(got) and all(
            torch.equal(a, b) for a, b in zip(want, got))

    def trial():
        shd.GATHERED.clear()
        layers.PRODUCTS.update(bf16=0, f32=0, f32_lowered=0)
        out = {"bare": bare()}
        want = train_once(shd.NULL_RULES)
        out["train"] = same(want, train_once(
            shd.for_mesh(shd.TRAIN_RULES, mesh1)))
        del want
        torch.cuda.empty_cache()
        rules = shd.for_mesh(shd.TRAIN_RULES, mesh1)
        want = trainer_once(shd.NULL_RULES, None, "plain")
        out["trainer"] = same(want, trainer_once(
            rules, (mesh1, param_specs(cfg1, rules)), "dtensor"))
        out["losses"] = want[0].tolist()
        del want
        torch.cuda.empty_cache()
        out["routes"] = dict(layers.PRODUCTS)
        out["gathered"] = dict(shd.GATHERED)
        return out

    with product_mode(False, "phase 8(c) bf16 train", hw):
        out, wall = run("one-card DTensor train step and Trainer, bf16",
                        trial)
    print(f"one-card mesh, bf16 products on DTensors ({hw}): bare "
          f"f32-result products on DTensors propagate, equal to the plain "
          f"product: {out['bare']}; qwen2.5-3b at its published width, one "
          f"train step (loss, gradient norm, every updated parameter) "
          f"bit-equal to the plain bf16 step: {out['train']}; two "
          f"Trainer(shardings=) steps of qwen2.5-3b cut to one layer "
          f"(losses {out['losses']}) bit-equal to plain Trainer steps: "
          f"{out['trainer']}; product routes {out['routes']}, ops gathered "
          f"{out['gathered']}; {wall:.1f} s")
    _check(all(out["bare"].values()), f"bare f32-result products on "
                                      f"DTensors: {out['bare']}")
    _check(out["train"] and out["trainer"], f"bf16-mode DTensor training "
           f"differs from the plain run: train step {out['train']}, "
           f"Trainer {out['trainer']}")
    _bf16_routes_held(dev, "one-card DTensor training", out["routes"],
                      out["gathered"])


def seq_sharded_decode(dev, hw, run):
    """Phase 8(d) (module docstring): decode's attention, cache write and
    MLA attention against a cache sharded along its sequence over "model"
    of a (1, 4) mesh on a fake group of 4 ranks (meta shards: nothing is
    sent), counted by `CollectiveCounter` at S and 2S; DTensor's own
    `amax` / `sum` over the sharded axis printed (the port builds its
    Partial reductions itself)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.analysis.collectives import (CollectiveCounter,
                                                  collective_bytes)
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import destroy_fake_world, init_fake_world
    from repro_torch.models import layers, lm, mla
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.specs import distribute

    b, s0, hq, hkv, d, pos = SEQ_SHAPES
    kv, q1 = [Shard(0), Shard(1)], [Shard(0), Replicate()]

    def meta(mesh, shape, pls, dtype=torch.bfloat16):
        local = list(shape)
        for n, p in zip(mesh.mesh.shape, pls):
            if isinstance(p, Shard):
                local[p.dim] //= int(n)
        return DTensor.from_local(
            torch.empty(local, dtype=dtype, device="meta"), mesh, pls,
            run_check=False, shape=torch.Size(shape),
            stride=torch.empty(shape, device="meta").stride())

    def counted(fn, *args):
        shd.GATHERED.clear()
        # the strided-view counter above the collective counter, which
        # hides DTensor ops from the modes below it
        with shd.GatherFallback(), CollectiveCounter() as cc, \
                shd.StridedViews() as views:
            fn(*args)
        got = {k: v for k, v in collective_bytes(cc.events).items()
               if k != "total" and v}
        return got, dict(shd.GATHERED), views.sites

    def cases(mesh, s):
        out = {}
        for mode in ("grouped", "repeat_kv"):
            for safe in (True, False):
                layers.set_gqa_mode(mode)
                layers.set_exec_safe(safe)
                out[f"attend {mode} {'exec-safe' if safe else 'bf16'}"] = \
                    counted(layers.gqa_attend,
                            meta(mesh, (b, 1, hq, d), q1),
                            meta(mesh, (b, s, hkv, d), kv),
                            meta(mesh, (b, s, hkv, d), kv),
                            meta(mesh, (b, 1, s), [Shard(0), Shard(2)],
                                 torch.bool))
        out["write"] = counted(lm.write_row, meta(mesh, (b, s, hkv, d), kv),
                               pos, meta(mesh, (b, 1, hkv, d), q1))
        cfg = reduced(get_config("deepseek-v3-671b"))
        p = mla.MLA(cfg, torch.device("meta"))
        for name, t in list(p.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            setattr(p.get_submodule(owner), leaf, torch.nn.Parameter(
                distribute(t, (), mesh), requires_grad=False))
        q_pos, kv_pos = lm._decode_positions(b, s, pos, "meta")
        with shd.dtensor_run(p):
            out["mla"] = counted(
                mla.decode_mla, p, cfg, meta(mesh, (b, 1, cfg.d_model), q1),
                q_pos, meta(mesh, (b, s, cfg.mla.kv_lora_rank), kv),
                meta(mesh, (b, s, cfg.mla.rope_head_dim), kv), kv_pos)
        return out

    def trial():
        init_fake_world(4)
        try:
            shd.register_product_strategies()
            mesh = DeviceMesh(dev.type, torch.arange(4).reshape(1, 4),
                              mesh_dim_names=("data", "model"))
            sc = meta(mesh, (b, hkv, 8, 1, s0), [Shard(0), Shard(4)],
                      torch.float32)
            own = {"amax": str(sc.amax(-1, keepdim=True).placements[1]),
                   "sum": str(sc.sum(-1, keepdim=True).placements[1])}
            try:
                return own, {s: cases(mesh, s) for s in (s0, 2 * s0)}
            finally:
                layers.set_gqa_mode("grouped")
                layers.set_exec_safe(False)
        finally:
            destroy_fake_world()

    (own, got), wall = run("decode on a sequence-sharded cache, fake "
                           "group of 4", trial)
    print(f"sequence-sharded decode ({hw}, torch {torch.__version__}): "
          f"DTensor's own reductions over the sharded axis: {own}; "
          f"collective bytes a rank at S = {s0} / {2 * s0}: "
          + "; ".join(f"{k} {got[s0][k][0]} / {got[2 * s0][k][0]} "
                      f"(gathered {got[s0][k][1]}, strided views "
                      f"{got[s0][k][2]})" for k in got[s0])
          + f"; {wall:.1f} s")
    for s, cs in got.items():
        for k, (bytes_, gathered, strided) in cs.items():
            want = GSPMD_DECODE_BYTES[k.split()[0]]
            _check(bytes_ == want and not gathered and not strided,
                   f"sequence-sharded decode, {k} at S = {s}: collectives "
                   f"{bytes_} (GSPMD: {want}), gathered {gathered}, "
                   f"strided views {strided}")


def seq_parallel_products(dev, hw, run):
    """Phase 8(e) (module docstring): the attention and MLP blocks under a
    sequence-parallel residual on a fake group of 4 ranks (meta shards:
    nothing is sent), their collectives counted by kind and dtype, and the
    f32 Partial sums cast to bf16 by `PartialCasts`."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.analysis.collectives import (CollectiveCounter,
                                                  collective_bytes_by_dtype)
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import destroy_fake_world, init_fake_world
    from repro_torch.models import layers
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.specs import distribute

    arch, b, s = SEQ_PARALLEL_SHAPES
    qwen = SEQ_PARALLEL_KV_ON_HEAD_DIM
    cfgs = {a: reduced(get_config(a)) for a in (arch, qwen)}

    def block(name, kind, safe, arch=arch, gqa="grouped"):
        cfg = cfgs[arch]
        mesh = DeviceMesh(dev.type, torch.arange(4).reshape(
            SEQ_PARALLEL_MESHES[kind]), mesh_dim_names=("data", "model"))
        rules = shd.for_mesh(shd.TRAIN_RULES if kind == "train"
                             else shd.PREFILL_RULES, mesh)
        shd.set_active_axis_sizes(dict(zip(("data", "model"),
                                           SEQ_PARALLEL_MESHES[kind])))
        layers.set_exec_safe(safe)
        layers.set_gqa_mode(gqa)
        train = kind == "train"
        if name == "attention":
            mod = layers.Attention(cfg, "meta")
            specs = layers.attention_specs(rules)
            pos = torch.arange(s, device="meta")[None].expand(b, s)

            def fn(x):
                return mod(cfg, x, pos, rules=rules)
        else:
            mod = layers.MLP(cfg.d_model, cfg.d_ff, device="meta")
            specs = layers.mlp_specs(rules)

            def fn(x):
                return mod(x, rules)
        for n, p in list(mod.named_parameters()):
            setattr(mod, n, torch.nn.Parameter(
                distribute(p, specs[n], mesh), requires_grad=train))
        x = distribute(torch.empty(b, s, cfg.d_model, dtype=torch.bfloat16,
                                   device="meta"), rules.resid, mesh)
        x.requires_grad_(train)
        shd.GATHERED.clear()
        # the gather fallback inside the counter, which hands DTensor ops
        # on past the modes below it
        with CollectiveCounter() as cc, shd.dtensor_run(mod), \
                shd.PartialCasts() as casts, shd.StridedViews() as views:
            out = fn(x)
            if train:
                out.float().sum().backward()
        return (collective_bytes_by_dtype(cc.typed), casts.count,
                dict(shd.GATHERED), views.sites)

    def trial():
        init_fake_world(4)
        try:
            shd.register_product_strategies()
            runs = {(arch, name, kind, mode, "grouped"): block(
                name, kind, mode == "exec-safe")
                for name in ("attention", "mlp")
                for kind in SEQ_PARALLEL_MESHES
                for mode in ("bf16", "exec-safe")}
            runs.update({(qwen, "attention", kind, mode, gqa): block(
                "attention", kind, mode == "exec-safe", qwen, gqa)
                for kind in SEQ_PARALLEL_MESHES
                for mode in ("bf16", "exec-safe")
                for gqa in ("grouped", "repeat_kv")})
            return runs
        finally:
            layers.set_exec_safe(False)
            layers.set_gqa_mode("grouped")
            shd.set_active_axis_sizes(None)
            destroy_fake_world()

    got, wall = run("sequence-parallel blocks, fake group of 4", trial)
    reductions = ("all-reduce", "reduce-scatter")
    # the prefill forward's row-parallel sum onto the residual: (B, S, D)
    # f32 over the sequence's four shards
    resid = b * s // 4 * cfgs[qwen].d_model * 4
    for (a, name, kind, mode, gqa), (typed, casts, gathered, strided) \
            in got.items():
        red = {k: int(v) for k, v in typed.items()
               if k.split()[0] in reductions}
        label = f"{a} {name} {kind} {mode} {gqa}"
        print(f"sequence-parallel {label} ({hw}, torch "
              f"{torch.__version__}): reductions {red or 'none'}; all "
              f"collectives {dict((k, int(v)) for k, v in typed.items())}; "
              f"f32 Partial sums cast to bf16 {casts}; gathered "
              f"{gathered}; strided views {strided}")
        _check(all(k.split()[1] == "f32" for k in red) and casts == 0,
               f"sequence-parallel {label}: reductions {red}, "
               f"{casts} f32 Partial sums cast to bf16")
        views = {op: n for op, n in gathered.items() if op in VIEW_OPS}
        _check(not views and not strided,
               f"sequence-parallel {label}: views gathered {views}, "
               f"strided views {strided}")
        if a == qwen:
            limit = (resid if kind == "prefill"
                     else GSPMD_QWEN_TRAIN_REDUCTION_BYTES)
            _check(sum(red.values()) <= limit,
                   f"sequence-parallel {label}: {sum(red.values())} B "
                   f"reduced, above {limit} B (the f32 scores reduced?)")
    print(f"sequence-parallel blocks: {wall:.1f} s ({hw})")


def dryrun_phase(dev, hw, drive, counters, train):
    """Phase 8: the sharding rules and the multi-pod dry-run (module
    docstring, item 8). `train` is phase 6c's summary (step times, peak
    memory)."""
    import os
    import tempfile

    import torch

    from repro_torch import models
    from repro_torch.analysis.op_cost import flops
    from repro_torch.analysis.roofline import F32_OPS_PER_S
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticTokenSource
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (destroy_fake_world, init_fake_world,
                                         make_host_mesh)
    from repro_torch.models import layers
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import batch_to, make_train_step

    t_phase = time.perf_counter()

    def run(label, fn):
        out, wall = drive(label, fn, needs=())
        launched = {k: n for c in counters for k, n in c.items() if n}
        _check(not launched, f"{label}: launched {launched}; the dry-run "
                             f"and the rules call no kernel")
        return out, wall

    # (a) the integration tests' cells and qwen2.5-3b decode_32k, one
    # subprocess each, all at once
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        def cells():
            procs = []
            for arch, shape, mesh in DRYRUN_CELLS:
                out = Path(tmp) / f"{arch}-{shape}-{mesh}.json"
                procs.append((out, subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", mesh,
                     "--out", str(out)], env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)))
            got = []
            for out, p in procs:
                log, _ = p.communicate(timeout=600)
                _check(p.returncode == 0, f"dry-run cell failed:\n{log}")
                got.append(json.loads(out.read_text())[0])
            return got
        got, wall = run("dryrun integration cells", cells)
    for c in got:
        line = f"dryrun {c['arch']} x {c['shape']} x {c['mesh']} " \
               f"({c['chips']} cards, {hw}): {c['status']}"
        if c["status"] == "ok":
            rl, mem = c["roofline"], c["memory"]
            line += (f", trace {c['compile_s']:.1f} s, FLOPs "
                     f"{rl['flops']:.4g} (GEMM {c['gemm_flops']:.4g}), "
                     f"per-device arguments "
                     f"{_gib(mem['argument_size_in_bytes'])}, outputs "
                     f"{_gib(mem['output_size_in_bytes'])}, donated "
                     f"{_gib(mem['alias_size_in_bytes'])}, temp (lower "
                     f"bound) {_gib(mem['temp_size_in_bytes'])}, "
                     f"collectives/card {c['collectives']} counts "
                     f"{c['collective_counts']}, t_compute "
                     f"{rl['t_compute_s']:.4g} s, t_memory "
                     f"{rl['t_memory_s']:.4g} s, t_collective "
                     f"{rl['t_collective_s']:.4g} s, bottleneck "
                     f"{rl['bottleneck']}, useful FLOPs "
                     f"{rl['useful_flops_ratio']:.4f}, roofline fraction "
                     f"{rl['roofline_fraction']:.3g}, gathered ops "
                     f"{c['replicated_ops']}")
        print(line)
    by = {(c["arch"], c["shape"]): c for c in got}
    c = by[("granite-3-2b", "decode_32k")]
    _check(c["status"] == "ok" and c["chips"] == 256
           and c["roofline"]["flops"] > 0 and c["roofline"]["t_memory_s"] > 0
           and c["roofline"]["bottleneck"] in ("compute", "memory",
                                               "collective"),
           "dry-run: the single-pod decode cell")
    c = by[("h2o-danube-1.8b", "train_4k")]
    _check(c["status"] == "ok" and c["chips"] == 512
           and c["collectives"]["total"] > 0
           and c["roofline"]["useful_flops_ratio"] > 0.05,
           "dry-run: the multi-pod train cell")
    _check(by[("qwen2.5-3b", "long_500k")]["status"] == "skipped"
           and by[("rwkv6-7b", "long_500k")]["status"] == "ok",
           "dry-run: the long-context skip policy")
    print(f"dryrun cells: {wall:.1f} s for the {len(DRYRUN_CELLS)} "
          f"subprocesses at once")

    # (b) phase 6c's step: the abstract cell on the host mesh against the
    # same counter around one real step on the card, in each product mode
    cfg = get_config("qwen2.5-3b")
    shape = ShapeConfig("train_4k_batch_1", TRAIN_SEQ, TRAIN_BATCH, "train")
    traced, real = {}, {}
    for exec_safe in (True, False):
        mode = "exec-safe" if exec_safe else "bf16"
        with product_mode(exec_safe, f"phase 8(b) {mode}", hw):
            init_fake_world()
            try:
                mesh = make_host_mesh("cuda")
                layers.PRODUCTS.update(bf16=0, f32=0, f32_lowered=0)
                (cell, t_cell) = run(
                    f"dryrun qwen2.5-3b step on the host mesh, {mode}",
                    lambda: dryrun.measure_cell(cfg, shape, mesh))
                traced[mode] = cell, t_cell, dict(layers.PRODUCTS)
            finally:
                destroy_fake_world()
            torch.cuda.empty_cache()
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            model = models.init_params(cfg, gen, device=dev)
            opt_cfg = adamw.AdamWConfig(moment_dtype=torch.float32)
            state = adamw.init(opt_cfg, dict(model.named_parameters()))
            batch = batch_to(SyntheticTokenSource(cfg, shape,
                                                  seed=0).batch_at(0), dev)
            layers.PRODUCTS.update(bf16=0, f32=0, f32_lowered=0)
            real[mode] = run(
                f"counted qwen2.5-3b step on the card, {mode}",
                lambda: flops(make_train_step(cfg, opt_cfg, remat=True),
                              model, state, batch)) + (
                dict(layers.PRODUCTS),)
            del model, state, batch
            torch.cuda.empty_cache()
        cell, t_cell, routes = traced[mode]
        counted, t_real, real_routes = real[mode]
        mem = cell["memory"]
        print(f"qwen2.5-3b step ({hw}), {mode} products: abstract cell "
              f"(host mesh {tuple(mesh.mesh.shape)}, traced in "
              f"{t_cell:.1f} s, product routes {routes}) GEMM FLOPs "
              f"{cell['gemm_flops']}, total {cell['roofline']['flops']}, "
              f"collectives/card {cell['collectives']}, temp (lower bound) "
              f"{mem['temp_size_in_bytes']} B, gathered ops "
              f"{cell['replicated_ops']}; one real step counted "
              f"({t_real:.1f} s, product routes {real_routes}): GEMM "
              f"{counted.gemm}, total {counted.total}")
        _check(cell["gemm_flops"] == counted.gemm,
               f"{mode}: abstract GEMM FLOPs {cell['gemm_flops']} != the "
               f"real step's {counted.gemm}")
        if not exec_safe:
            _check(routes["f32"] == 0, f"the bf16-mode trace multiplied "
                                       f"f32 operands: {routes}")
            _bf16_routes_held(dev, "the bf16-mode step", real_routes,
                              cell["replicated_ops"])
    safe, bf16 = traced["exec-safe"][0], traced["bf16"][0]
    _check(safe["gemm_flops"] == bf16["gemm_flops"],
           f"GEMM FLOPs differ between the modes: exec-safe "
           f"{safe['gemm_flops']}, bf16 {bf16['gemm_flops']}")
    if dev.type == "cuda" and (TRAIN_SEQ, TRAIN_BATCH) == (4096, 1):
        _check(bf16["gemm_flops"] == QWEN_STEP_GEMM_FLOPS,
               f"GEMM FLOPs {bf16['gemm_flops']} != the step's "
               f"{QWEN_STEP_GEMM_FLOPS}")
    _check(bf16["collectives"]["total"] <= safe["collectives"]["total"],
           f"bf16 mode moves more collective bytes: {bf16['collectives']} "
           f"against {safe['collectives']}")
    print(f"qwen2.5-3b step ({hw}), bf16 against exec-safe products: "
          f"temp (lower bound) {bf16['memory']['temp_size_in_bytes']} / "
          f"{safe['memory']['temp_size_in_bytes']} B, collectives/card "
          f"{bf16['collectives']['total']} / "
          f"{safe['collectives']['total']} B, total FLOPs "
          f"{bf16['roofline']['flops']} / {safe['roofline']['flops']}, "
          f"trace {traced['bf16'][1]:.1f} / {traced['exec-safe'][1]:.1f} s")
    cell = safe
    rl, mem = cell["roofline"], cell["memory"]
    t_f32 = rl["flops"] / (rl["chips"] * F32_OPS_PER_S)
    med = statistics.median(train["step_s"])
    print(f"qwen2.5-3b step roofline ({hw}), exec-safe: t_compute "
          f"{rl['t_compute_s']:.4f} s at bf16 peak, {t_f32:.4f} s at the "
          f"f32 rate, t_memory {rl['t_memory_s']:.4f} s, t_collective "
          f"{rl['t_collective_s']:.4f} s, bottleneck {rl['bottleneck']}; "
          f"measured step (phase 6c) {med:.3f} s = {med / t_f32:.2f}x the "
          f"f32 compute term")
    print(f"qwen2.5-3b step memory ({hw}), exec-safe: arguments "
          f"{_gib(mem['argument_size_in_bytes'])} + temp lower bound "
          f"{_gib(mem['temp_size_in_bytes'])} = "
          f"{_gib(mem['argument_size_in_bytes'] + mem['temp_size_in_bytes'])}"
          f"; measured peak (phase 6c) {train['peak_gib']:.2f} GiB")

    # (c) the rules on one card, at qwen2.5-3b's published width
    one_card_rules(dev, hw, run, cfg)
    # (d) decode against a sequence-sharded cache, on this torch
    seq_sharded_decode(dev, hw, run)
    # (e) sequence-parallel row-parallel products, on this torch
    seq_parallel_products(dev, hw, run)
    c = by[("qwen2.5-3b", "decode_32k")]
    gathered = c["collectives"].get("all-gather", 0)
    print(f"qwen2.5-3b decode_32k single ({hw}): all-gather "
          f"{gathered} B a card, all-reduce "
          f"{c['collectives'].get('all-reduce', 0)} B, bottleneck "
          f"{c['roofline']['bottleneck']}")
    _check(c["status"] == "ok" and gathered <= QWEN_DECODE_ALL_GATHER_MAX,
           f"qwen2.5-3b decode_32k gathers {gathered} B a card")
    print(f"phase 8 wall time: {time.perf_counter() - t_phase:.1f} s ({hw})")
    return got


# The noisy photonic LM head's rel_err over the noise-free head's on the
# same operands: tests/test_torch_examples_serve.py's NOISE_BAND (the
# reference's keys 0-7, widened by their spread on each side).
PHOTONIC_NOISE_BAND = (0.9968, 1.0039)


def load_example(name: str):
    """`examples/<name>_torch.py`, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nan_as_text(x):
    """`x` with every float NaN as "nan" (an infeasible result's metrics
    are NaN, and NaN != NaN), so that `==` compares exactly."""
    if isinstance(x, float) and x != x:
        return "nan"
    if isinstance(x, dict):
        return {k: _nan_as_text(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_nan_as_text(v) for v in x)
    return x


def examples_phase(dev, hw, drive):
    """Phase 8b: the four examples (`examples/*_torch.py`), each through
    its `main([...])` in this process, their printed lines captured.
    `drive(label, fn, needs)` is phase 4c's, counting under the path
    "examples" and returning `(fn(), wall, counts)`. Returns the phase's
    wall times."""
    import contextlib
    import io

    import torch

    from repro_torch import models
    from repro_torch.configs import get_config, reduced
    from repro_torch.kernels.ref import ddot_matmul_ref

    t_phase = time.perf_counter()
    mods = {n: load_example(n) for n in ("quickstart", "arch_cosearch",
                                         "scenario_zoo", "serve_photonic")}
    walls = []

    def run(name, argv, needs=()):
        """One `main` on the card under `drive`: (returned data, wall s,
        launch counts, printed text)."""
        text = io.StringIO()
        argv = [*argv, "--device", str(dev)]
        label = f"{name} {' '.join(argv)}"
        with contextlib.redirect_stdout(text):
            out, wall, counts = drive(label, lambda: mods[name].main(argv),
                                      needs)
        walls.append((label, wall))
        return out, wall, counts, text.getvalue()

    def run_cpu(name, argv):
        """The same `main` with --device cpu (the plain versions): (returned
        data, wall s)."""
        with contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            out = mods[name].main([*argv, "--device", "cpu"])
            wall = time.perf_counter() - t0
        walls.append((f"{name} {' '.join(argv)} --device cpu", wall))
        return out, wall

    def lines_with(text, *keys):
        return [ln.strip() for ln in text.splitlines()
                if any(k in ln for k in keys)]

    def launched(counts):
        return {k: n for k, n in counts.items() if n}

    # (a) quickstart: Alg. 1, Alg. 2 (python engine), the exhaustive check
    got, wall, counts, text = run("quickstart", [])
    want, wall_cpu = run_cpu("quickstart", [])
    _check(_nan_as_text(got) == _nan_as_text(want),
           f"quickstart on the card differs from --device cpu: {got} != "
           f"{want}")
    _check(not launched(counts), f"quickstart launched {launched(counts)}; "
                                 f"its path runs no kernel")
    print(f"examples (a) quickstart deit-b: found {got['found']['config']}, "
          f"exhaustive {got['exhaustive']['config']}, EDP ratio "
          f"{got['edp_ratio']!r}, equal to --device cpu; wall {wall:.4f} s "
          f"(cpu {wall_cpu:.4f} s); steps: "
          + "; ".join(lines_with(text, "evaluated", "exhaustive best"))
          + f" ({hw})")

    # (b) arch_cosearch: the zoo table on every engine, then the scenarios
    rows = {}
    for engine in ("numpy", "python", "torch", "cuda"):
        out, wall, counts, _ = run("arch_cosearch", ["--engine", engine],
                                   ("dse_search_padded",)
                                   if engine == "cuda" else ())
        rows[engine] = _nan_as_text(out["rows"])
        if engine != "cuda":
            _check(not launched(counts), f"arch_cosearch --engine {engine} "
                                         f"launched {launched(counts)}")
        print(f"examples (b) arch_cosearch --engine {engine}: "
              f"{sum(r[0] for r in out['rows'].values())} of "
              f"{len(out['rows'])} archs feasible, launches "
              f"{launched(counts)}, wall {wall:.4f} s ({hw})")
    for engine in ("python", "torch", "cuda"):
        _check(rows[engine] == rows["numpy"],
               f"arch_cosearch --engine {engine} rows differ from numpy's")
    kernel = {"edp": "dse_search_padded", "pareto": "dse_pareto_padded"}
    for mode in ("edp", "pareto"):
        argv = ["--scenarios"] + (["--pareto"] if mode == "pareto" else [])
        want, wall_np, _, _ = run("arch_cosearch",
                                  [*argv, "--engine", "numpy"])
        got, wall, counts, _ = run("arch_cosearch",
                                   [*argv, "--engine", "cuda"],
                                   (kernel[mode],))
        _check(got["rows"] == want["rows"],
               f"arch_cosearch --scenarios ({mode}) --engine cuda differs "
               f"from numpy")
        per_box = got["launches"]
        total = {}
        for box, ran in per_box.items():
            _check(ran.get(kernel[mode], 0) <= 1,
                   f"arch_cosearch --scenarios ({mode}) {box}: launched "
                   f"{kernel[mode]} {ran.get(kernel[mode])} times")
            for k, n in ran.items():
                total[k] = total.get(k, 0) + n
        _check(total == launched(counts),
               f"arch_cosearch --scenarios ({mode}): the example counted "
               f"{total}, the phase {launched(counts)}")
        print(f"examples (b) arch_cosearch --scenarios ({mode}) --engine "
              f"cuda: equal to numpy; per scenario " + "; ".join(
                  f"{a:.0f}mm^2/{p:.1f}W {got['walls'][(a, p)]:.4f} s, "
                  f"launches {per_box[(a, p)]} (numpy "
                  f"{want['walls'][(a, p)]:.4f} s)" for a, p in per_box)
              + f"; wall {wall:.4f} s (numpy {wall_np:.4f} s) ({hw})")

    # (c) scenario_zoo at the published configs, cuda service vs numpy
    want, _, _, _ = run("scenario_zoo", ["--full", "--engine", "numpy"])
    got, wall, counts, _ = run("scenario_zoo", ["--full", "--engine",
                                                "cuda"])
    _check(got["report"] == want["report"],
           "scenario_zoo --full --engine cuda: report differs from numpy's")
    _check(got["memo_hits"] == got["n_scenarios"] == 40,
           f"scenario_zoo repeat sweep: {got['memo_hits']}/"
           f"{got['n_scenarios']} memoized")
    print(f"examples (c) scenario_zoo --full --engine cuda: report equal to "
          f"numpy's ({got['report'].splitlines()[0]}), cold sweep "
          f"{got['cold_s']:.4f} s (numpy {want['cold_s']:.4f} s), repeat "
          f"{got['repeat_s']:.4f} s, {got['memo_hits']}/{got['n_scenarios']} "
          f"memoized; launches {launched(counts)}, wall {wall:.4f} s ({hw})")

    # (d) serve_photonic with the photonic LM head
    got, wall, counts, text = run("serve_photonic", ["--photonic"],
                                  ("ddot_gemm_quantized",))
    _check(launched(counts) == {"ddot_gemm_quantized": 1},
           f"serve_photonic --photonic launched {launched(counts)}, not one "
           f"ddot_gemm_quantized")
    _check(got["stats"]["tokens"] == 48 and len(got["tokens"]) == 12,
           f"serve_photonic served {got['stats']['tokens']} tokens")
    # the example's operands again: its weights (a generator on the card
    # seeded 0) and x (seeded 1); the noise-free head against its plain
    # version on the card
    cfg = reduced(get_config("qwen2.5-3b"))  # serve_photonic's default
    params = models.init_params(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.randn((4, cfg.d_model), generator=gen, device=dev)
    (q, _, clean), t_head, head_counts = drive(
        "photonic_head noise_rms 0",
        lambda: mods["serve_photonic"].photonic_head(
            x, params.embed.table, 0.0, 7, dev),
        ("ddot_gemm_quantized",))
    _check(launched(head_counts) == {"ddot_gemm_quantized": 1},
           f"photonic_head launched {launched(head_counts)}")
    plain = ddot_matmul_ref(x, params.embed.table.T.float())
    torch.cuda.synchronize()
    _check(torch.equal(q, plain), "photonic_head (noise_rms 0) differs from "
                                  "its plain version on the card")
    ratio = got["rel_err"] / clean
    lo, hi = PHOTONIC_NOISE_BAND
    _check(lo <= ratio <= hi, f"photonic head rel_err {got['rel_err']!r} is "
                              f"{ratio!r} of the noise-free {clean!r}, "
                              f"outside {PHOTONIC_NOISE_BAND}")
    want, wall_cpu = run_cpu("serve_photonic", [])
    _check(got["report"] == want["report"],
           f"photonic_report on the card differs from --device cpu: "
           f"{got['report']} != {want['report']}")
    print(f"examples (d) serve_photonic --photonic: 48 tokens, ttft_s "
          f"{got['stats']['ttft_s']!r}, decode_s_per_tok "
          f"{got['stats']['decode_s_per_tok']!r}; "
          + "; ".join(lines_with(text, "LM head"))
          + f"; noise-free head equal to plain, {t_head * 1e3:.3f} ms, "
          f"rel_err {got['rel_err']!r} = {ratio!r} x the noise-free "
          f"{clean!r}; report equal to --device cpu "
          f"({got['report']['pta_config']}); wall {wall:.4f} s (cpu "
          f"{wall_cpu:.4f} s) ({hw})")
    del params
    torch.cuda.empty_cache()
    print(f"phase 8b wall time: {time.perf_counter() - t_phase:.1f} s ({hw})")
    return walls


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
    # -- shard= on the main path (phase 4f) --------------------------------
    t_shard = time.perf_counter()
    shard_walls = shard_phase(dev, 24, smi.stdout.strip(),
                              drive_into("shard"), inp)
    print(f"phase 4f wall time: {time.perf_counter() - t_shard:.1f} s "
          f"({smi.stdout.strip()})")

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
    # Phase 6 holds the card to the CPU path and its stored figures in
    # exec-safe mode (f32 operands); phase 6d runs the bf16 mode.
    from repro_torch.models import layers
    layers.set_exec_safe(True)
    print(f"phase 6: products exec-safe (f32 operands) ({smi.stdout.strip()})")
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
    hw = smi.stdout.strip()
    with product_mode(True, "phase 6b", hw):
        family_rows = families_phase(dev, hw, drive, counters)
    # -- training on the card (phase 6c) -----------------------------------
    with product_mode(True, "phase 6c", hw):
        train = train_phase(dev, hw, drive, counters)
    # -- the products' bf16 mode (phase 6d) ---------------------------------
    precision = precision_phase(dev, hw, drive, counters, train)
    # -- the sharding rules and the multi-pod dry-run (phase 8), each step in
    # both product modes --------------------------------------------------
    dryrun_phase(dev, hw, drive, counters, train)
    # -- the four examples (phase 8b) ---------------------------------------
    with product_mode(True, "phase 8b", hw):
        examples_phase(dev, hw, drive_into("examples"))

    print(f"service wall times ({smi.stdout.strip()}): " + "; ".join(
        f"{label} {kind} {wall:.4f} s" for label, kind, wall in service_walls))
    print(f"scenario wall times ({smi.stdout.strip()}): " + "; ".join(
        f"{label} {wall:.4f} s" for label, wall in scenario_walls))
    print(f"worker wall times ({smi.stdout.strip()}): " + "; ".join(
        f"{label} " + (", ".join(f"workers={k} {v:.4f} s"
                                 for k, v in wall.items())
                       if isinstance(wall, dict) else f"{wall:.4f} s")
        for label, wall in worker_walls))
    print(f"shard wall times ({smi.stdout.strip()}): " + "; ".join(
        f"{label} {wall:.4f} s"
        + ("" if base is None else f" (shard=None {base:.4f} s)")
        for label, wall, base in shard_walls))
    print(f"family serving ({smi.stdout.strip()}): " + "; ".join(
        f"{arch} ttft {t[0]:.4f} / {t[1]:.4f} s, decode {d[0]:.4f} / "
        f"{d[1]:.4f} s/token, peak {peak:.2f} GiB, built in {b_s:.2f} s"
        for arch, t, d, peak, b_s in family_rows))
    print(f"training qwen2.5-3b at published width, seq {TRAIN_SEQ} batch "
          f"{TRAIN_BATCH} ({smi.stdout.strip()}): step "
          + ", ".join(f"{t:.3f}" for t in train["step_s"]) + " s, "
          + ", ".join(f"{r:.1f}" for r in train["tokens_per_s"])
          + f" tokens/s, peak {train['peak_gib']:.2f} GiB, device busy "
          f"{train['busy']:.4f}, forward {train['fwd_s']:.3f} s, forward + "
          f"backward {train['fwd_bwd_s']:.3f} s, AdamW {train['adamw_s']:.3f} "
          f"s")
    es, bf = precision["serve"]["exec-safe"], precision["serve"]["bf16"]
    print(f"products, bf16 against exec-safe ({smi.stdout.strip()}): "
          f"qwen2.5-3b step median "
          f"{statistics.median(precision['train']['step_s']):.3f} / "
          f"{statistics.median(train['step_s']):.3f} s, peak "
          f"{precision['train']['peak_gib']:.2f} / {train['peak_gib']:.2f} "
          f"GiB, device {precision['train']['device_s']:.3f} / "
          f"{train['device_s']:.3f} s; serving ttft "
          f"{bf['stats']['ttft_s']:.4f} / {es['stats']['ttft_s']:.4f} s, "
          f"decode {bf['stats']['decode_s_per_tok']:.4f} / "
          f"{es['stats']['decode_s_per_tok']:.4f} s/token, peak "
          f"{bf['peak_gib']:.2f} / {es['peak_gib']:.2f} GiB; products "
          f"within {precision['worst_ratio']:.4g} of the bound")
    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
