"""Hopper kernels for the DxPTA cost model and fused DSE search, each beside
its plain PyTorch version.

Six CUDA kernels (`csrc/dse_eval.cu`, built for sm_90a by `_build.py`)
replace the six Pallas kernels of `repro/kernels/dse_eval.py` that carry
the min-EDP and the Pareto-frontier searches. They share one device cost
model (hardware half, then the per-GEMM dataflow half) and one mixed-radix
decoder:

  * `dse_eval_padded`    — per-config (area, power, energy, latency);
  * `dse_search_padded`  — feasibility under dynamic (W, 4) bounds, EDP and
    a per-block (best EDP, first-hit index, feasible count) reduction with
    a carried-in best that wins exact ties;
  * `dse_search_decoded` — the same reduction over configs each lane
    decodes from its global index (factorized product spaces, optionally
    masked to a slab's digit ranges);
  * `dse_decode_rows`    — the decoded rows plus a validity row (the
    decoder's testable surface);
  * `dse_pareto_padded`  — per block of BLOCK lanes, the feasible
    block-local non-dominated set (the Pallas kernel's sort-then-triangle
    semantics, below), pruned against carried front points and compacted
    to at most MAX_FRONT lane indices;
  * `dse_pareto_decoded` — the same over decoded lanes, global indices.

Every wrapper takes tensors. Given CUDA tensors it launches its kernel (and
counts the launch in `LAUNCHES`) or raises; given CPU tensors it runs the
kernel's plain PyTorch version, `*_plain`, which repeats the kernel's
float32 arithmetic op for op with torch ops and emits the same layout.
`chip_smoke.py` runs both on the card and holds them equal.

Float32 semantics (the Pallas kernels' source, read as IEEE float32):

  (a) static Python-float subexpressions are folded in float64 and rounded
      once to float32 (JAX weak typing) — only the *maximal scalar
      subtrees* of Python's left-associative parse. `_folded_constants`
      and `_folded_workload` compute them on the host; the kernel and the
      plain version receive the same float32 values.
  (b) no FMA contraction (nvcc -fmad=false) and IEEE division; the plain
      version divides by a device tensor, never by a Python scalar (on
      CUDA that becomes a reciprocal multiply).
  (c) int32 ceil-division, then ((f32(cm) * f32(cn)) * f32(ck)) * count,
      GEMMs accumulated in list order.
  (d) float32 indices (exact below 2**24); invalid decoded lanes gather
      clamped candidate values.

Block-front semantics (`repro`'s `_block_front`, which is *not* plain
dominance): infeasible lanes get +inf objectives; the block is ordered by a
stable sort on objective 0 (ties by lane; -0.0 equals +0.0); a sorted row
can dominate only the rows after it, so a pair tied on objective 0 whose
dominator sits at the later lane is skipped and both stay; a column whose
DOM_CHUNK-tile starts at a non-finite objective 0 is never dominated (the
tile's `lax.cond` skip). Carried points then prune by strict dominance.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..core.factorized import decode_digits
from ..core.photonic_model import DeviceConstants

BLOCK = 2048          # configs per reduction block of the grid-operand kernel
DECODE_BLOCK = 16384  # lanes per reduction block of the decoded kernel
SEARCH_ROWS = 3       # per-workload output rows: (best_edp, best_idx, n_feasible)
CARRY_IDX = -2.0      # index emitted when the carried-in best wins the block
META_COLS = 12        # [start, end, lo_t, hi_t, lo_c, hi_c, lo_v, hi_v,
#                        lo_h, hi_h, lo_l, hi_l] of a decoded launch

MAX_FRONT = 128       # per-block emitted front indices (a larger front
#                       reports its true count; the host refines the block)
PARETO_HEADER = 2     # per-workload header rows: (front count, feasible count)
PARETO_ROWS = PARETO_HEADER + MAX_FRONT
DOM_CHUNK = 256       # column tile of the reference's dominance pass
CARRY_FRONT = 128     # carried-in front points per workload (+inf padded)
#: Metrics a frontier kernel can minimize, in the order of their codes.
PARETO_METRICS = ("area", "power", "energy", "latency", "edp")
#: Blocks per batched (n, n) dominance pass of the plain frontier version.
PLAIN_BATCH = 32

#: Launch counts of the six kernels, one plain integer each; a wrapper adds
#: one where it launches its kernel and nowhere else.
LAUNCHES = {"dse_eval_padded": 0, "dse_search_padded": 0,
            "dse_search_decoded": 0, "dse_decode_rows": 0,
            "dse_pareto_padded": 0, "dse_pareto_decoded": 0}

# Packed parameter block the kernels read (int32 words; floats bit-cast):
#   [W, n_gemms] + N_CONST folded constants + W * WL_WORDS workload records
#   ([a_sram, p_sram, t_mem, t_elec, e_dram] floats, gemm begin, gemm end)
#   + 4 words per GEMM ([m, k, n] int32, count float).
N_CONST = 23
WL_WORDS = 7
# The parameter block is dse_eval's dynamic shared memory: it must stay
# within the 48 KB a block gets without opting in to more (the frontier and
# search kernels opt in to it beside their own shared storage).
MAX_PARAM_WORDS = 12 * 1024 - 128


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _f32(x) -> float:
    """The float32 value of x (rounded once), as a Python float."""
    return float(np.float32(x))


def _folded_constants(c: DeviceConstants):
    """The N_CONST workload-independent constants, each the float32 value of
    its maximal Python-scalar subtree in `repro`'s `_config_metrics_hw/_wl`.
    Order matches the constants enum of csrc/dse_eval.cu."""
    return tuple(_f32(v) for v in (
        c.a_mzm + c.a_dac, c.a_ddot + c.a_acc, c.a_core_fixed,
        c.a_adc + c.a_tia, c.a_comb_base, c.a_comb_per_lambda,
        c.a_tile_fixed, c.a_inter_tile_net, c.a_chip_fixed,
        c.p_mzm + c.p_dac, c.p_pd, c.p_adc + c.p_tia, c.p_acc,
        c.p_core_fixed, c.p_comb_base, c.p_comb_per_lambda,
        c.p_laser_split, c.p_tile_fixed, c.p_inter_tile_net, c.p_chip_fixed,
        c.f_clk_hz, c.act_bits / 8.0, c.e_sram_per_byte))


def _folded_workload(wl_scalars, c: DeviceConstants):
    """(a_sram, p_sram, t_mem, t_elec, e_dram): the per-workload scalar
    subtrees, folded in float64 and rounded once to float32."""
    elec_ops, weight_bytes, act_io_bytes, sram_mb = wl_scalars
    return tuple(_f32(v) for v in (
        sram_mb * c.a_sram_per_mb, sram_mb * c.p_sram_per_mb,
        (weight_bytes + act_io_bytes) / c.dram_bw_bytes,
        elec_ops / c.elec_ops_per_s,
        c.e_dram_per_byte * (weight_bytes + act_io_bytes)))


def _gemm_ints(gemms):
    """((m, k, n) as Python ints, count as its float32 value) per GEMM."""
    return tuple((int(m), int(k), int(n), _f32(cnt))
                 for m, k, n, cnt in gemms)


def _param_words(workloads: tuple, c: DeviceConstants) -> np.ndarray:
    """The packed int32 parameter block of a launch (see the layout above)."""
    w = len(workloads)
    n_g = sum(len(g) for g, _ in workloads)
    head = np.asarray([w, n_g], np.int32)
    consts = np.asarray(_folded_constants(c), np.float32).view(np.int32)
    recs = []
    gem = []
    g0 = 0
    for gemms, scalars in workloads:
        f = np.asarray(_folded_workload(scalars, c), np.float32)
        recs.append(np.concatenate([f.view(np.int32),
                                    np.asarray([g0, g0 + len(gemms)],
                                               np.int32)]))
        for m, k, n, cnt in _gemm_ints(gemms):
            gem.append(np.concatenate([np.asarray([m, k, n], np.int32),
                                       np.asarray([cnt], np.float32)
                                       .view(np.int32)]))
        g0 += len(gemms)
    words = np.concatenate([head, consts] + recs + gem)
    assert len(consts) == N_CONST and len(recs[0]) == WL_WORDS
    if len(words) > MAX_PARAM_WORDS:
        raise ValueError(f"{w} workloads with {n_g} GEMMs need "
                         f"{len(words)} parameter words; the kernels take "
                         f"at most {MAX_PARAM_WORDS} (48 KB of shared "
                         f"memory) — split the batch")
    return words


@functools.lru_cache(maxsize=64)
def _device_params(workloads: tuple, c: DeviceConstants,
                   device: torch.device) -> torch.Tensor:
    """The parameter block resident on `device`, copied once per launch key
    (a search's repeated launches share it)."""
    return torch.from_numpy(_param_words(workloads, c)).to(device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path; the card's reference)
# ---------------------------------------------------------------------------

def _config_metrics_hw(k, wl, t, c_, h, v, l_):
    """(area, power) of config columns — the hardware half, in the order of
    `repro`'s `_config_metrics_hw` (left-associative sums, folded scalars)."""
    a_mod, a_ddot, a_core, a_adc, a_comb0, a_comb1, a_tile, a_net, a_chip, \
        p_mod, p_pd, p_adc, p_acc, p_core, p_comb0, p_comb1, p_laser, \
        p_tile, p_net, p_chip = k[:20]
    a_sram, p_sram = wl[0], wl[1]
    cores = t * c_
    mod_channels = cores * (h + v) * l_
    ddots = cores * h * v
    adc_chains = t * h * v
    area = mod_channels * a_mod
    area = area + ddots * a_ddot
    area = area + cores * a_core
    area = area + adc_chains * a_adc
    area = area + t * (a_comb1 * l_ + a_comb0)
    area = area + t * a_tile
    area = area + a_net * t * t
    area = area + a_sram
    area = area + a_chip
    power = mod_channels * p_mod
    power = power + ddots * 2 * p_pd
    power = power + adc_chains * p_adc
    power = power + ddots * p_acc
    power = power + cores * p_core
    power = power + t * (p_comb1 * l_ + p_comb0)
    power = power + t * p_laser * l_ * h * v
    power = power + t * p_tile
    power = power + p_net * t * t
    power = power + p_sram
    power = power + p_chip
    return area, power


def _config_metrics_wl(k, wl, gemms, power, t, c_, h, v, l_):
    """(energy, latency) of config columns — the per-GEMM dataflow half, in
    the order of `repro`'s `_config_metrics_wl`."""
    f_clk = torch.full((), k[20], dtype=torch.float32, device=t.device)
    sram_scale, e_sram = k[21], k[22]
    t_mem, t_elec, e_dram = wl[2], wl[3], wl[4]
    lanes = (t * h + v) * c_ * l_
    d_m = (t * h).to(torch.int32)
    d_n = v.to(torch.int32)
    d_k = (c_ * l_).to(torch.int32)
    total = torch.zeros_like(t)
    sram_lane = torch.zeros_like(t)
    for m, kk, n, cnt in gemms:
        cm = torch.floor_divide(d_m + (m - 1), d_m)
        cn = torch.floor_divide(d_n + (n - 1), d_n)
        ck = torch.floor_divide(d_k + (kk - 1), d_k)
        cyc = cm.float() * cn.float() * ck.float() * cnt
        total = total + cyc
        sram_lane = sram_lane + cyc * lanes
    t_photonic = torch.div(total, f_clk)
    latency = torch.clamp_min(t_photonic, t_mem) + t_elec
    sram_bytes = sram_lane * sram_scale
    energy = power * latency + e_dram + sram_bytes * e_sram
    return energy, latency


def _statics(workloads, c):
    return (_folded_constants(c),
            [(_folded_workload(s, c), _gemm_ints(g)) for g, s in workloads])


def dse_eval_padded_plain(cfg_cols: torch.Tensor, *, gemms: tuple,
                          wl_scalars: tuple,
                          constants: DeviceConstants) -> torch.Tensor:
    """Plain version of `dse_eval_padded`: (5, G) float32 -> (4, G)."""
    k, ((wl, gm),) = _statics(((gemms, wl_scalars),), constants)
    cols = tuple(cfg_cols[i] for i in range(5))
    area, power = _config_metrics_hw(k, wl, *cols)
    energy, latency = _config_metrics_wl(k, wl, gm, power, *cols)
    return torch.stack([area, power, energy, latency])


def _search_reduce_plain(workloads, c, cols, valid, idx, cons, carry,
                         block: int) -> torch.Tensor:
    """Per-block (best EDP, first-hit index, feasible count) with the carry
    rule, over lanes laid out as (n_blocks * block,) vectors."""
    k, per_wl = _statics(workloads, c)
    n_blocks = valid.shape[0] // block
    lane = torch.arange(block, dtype=torch.int64, device=valid.device)
    out = torch.empty((SEARCH_ROWS * len(workloads), n_blocks),
                      dtype=torch.float32, device=valid.device)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=valid.device)
    for w, (wl, gm) in enumerate(per_wl):
        area, power = _config_metrics_hw(k, wl, *cols)
        energy, latency = _config_metrics_wl(k, wl, gm, power, *cols)
        ok = (valid & (area < cons[w, 0]) & (power < cons[w, 1])
              & (energy < cons[w, 2]) & (latency < cons[w, 3]))
        edp = torch.where(ok, energy * latency, inf).view(n_blocks, block)
        best = edp.amin(dim=1)
        first = torch.where(edp == best[:, None], lane, block).amin(dim=1)
        best_idx = idx.view(n_blocks, block).gather(1, first[:, None])[:, 0]
        carried = carry[w, 0] <= best
        out[SEARCH_ROWS * w] = torch.where(carried, carry[w, 0], best)
        out[SEARCH_ROWS * w + 1] = torch.where(
            carried, torch.full_like(best, CARRY_IDX), best_idx)
        out[SEARCH_ROWS * w + 2] = ok.view(n_blocks, block).sum(dim=1).float()
    return out


def _pad_cols(cfg_cols: torch.Tensor, mask: torch.Tensor):
    """Pad (5, G) / (1, G) to a BLOCK multiple: all-ones configs, masked."""
    pad = (-cfg_cols.shape[1]) % BLOCK
    if pad:
        cfg_cols = torch.nn.functional.pad(cfg_cols, (0, pad), value=1.0)
        mask = torch.nn.functional.pad(mask, (0, pad), value=0.0)
    return cfg_cols, mask


def dse_search_padded_plain(cfg_cols, mask, cons, carry, *, workloads: tuple,
                            constants: DeviceConstants) -> torch.Tensor:
    """Plain version of `dse_search_padded`: (3W, ceil(G / BLOCK))."""
    cfg_cols, mask = _pad_cols(cfg_cols, mask)
    g = cfg_cols.shape[1]
    n_blocks = g // BLOCK
    dev = cfg_cols.device
    base = (torch.arange(n_blocks, dtype=torch.int32, device=dev)
            * BLOCK).float()
    idx = (base[:, None] + torch.arange(BLOCK, dtype=torch.int32,
                                        device=dev).float()[None, :])
    cols = tuple(cfg_cols[i] for i in range(5))
    return _search_reduce_plain(workloads, constants, cols, mask[0] > 0.0,
                                idx.reshape(-1), cons, carry, BLOCK)


def _decode_block_plain(radices, axes, meta, n_blocks: int, block: int):
    """Plain version of the kernels' decoder: ((n_t, n_c, n_h, n_v,
    n_lambda) float32 columns, float32 global indices, validity) for
    n_blocks * block lanes starting at meta[0]."""
    dev = axes.device
    gidx = meta[0] + torch.arange(n_blocks * block, dtype=torch.int32,
                                  device=dev)
    digits = decode_digits(gidx, radices)
    valid = gidx < meta[1]
    for ax, d in enumerate(digits):
        valid = valid & (d >= meta[2 + 2 * ax]) & (d < meta[3 + 2 * ax])
    top = axes.shape[1] - 1

    def pick(row, digit):
        return axes[row][digit.clamp(0, top).long()]

    d_t, d_c, d_v, d_h, d_l = digits
    cols = (pick(0, d_t), pick(1, d_c), pick(3, d_h), pick(2, d_v),
            pick(4, d_l))
    return cols, gidx.float(), valid


def dse_search_decoded_plain(axes, meta, cons, carry, *, radices: tuple,
                             n_blocks: int, workloads: tuple,
                             constants: DeviceConstants) -> torch.Tensor:
    """Plain version of `dse_search_decoded`: (3W, n_blocks)."""
    cols, idx, valid = _decode_block_plain(radices, axes, meta, n_blocks,
                                           DECODE_BLOCK)
    return _search_reduce_plain(workloads, constants, cols, valid, idx, cons,
                                carry, DECODE_BLOCK)


def dse_decode_rows_plain(axes, meta, *, radices: tuple,
                          n_blocks: int) -> torch.Tensor:
    """Plain version of `dse_decode_rows`: (6, n_blocks * BLOCK)."""
    cols, _, valid = _decode_block_plain(radices, axes, meta, n_blocks, BLOCK)
    return torch.stack(list(cols) + [valid.float()])


def _block_front_plain(objs, ok):
    """(B, n) mask of block-locally non-dominated feasible lanes, B blocks
    at once, with the Pallas kernel's semantics (module docstring): one
    masked (K, K) comparison per block over the sorted prefix that holds
    every feasible lane (rows past it cannot precede a feasible column)."""
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=ok.device)
    o = [torch.where(ok, x, inf) for x in objs]
    n = ok.shape[1]
    order = torch.sort(o[0], dim=1, stable=True).indices
    so = [x.gather(1, order) for x in o]
    s_ok = ok.gather(1, order)
    pos = torch.arange(n, device=ok.device)
    k = int(torch.where(s_ok, pos + 1, 0).max())
    dominated = torch.zeros_like(ok)
    if k > 1:
        le = lt = None
        for x in so:
            r, c = x[:, :k, None], x[:, None, :k]
            le = (r <= c) if le is None else le & (r <= c)
            lt = (r < c) if lt is None else lt | (r < c)
        tri = pos[:k, None] < pos[None, :k]
        dom = (le & lt & tri).any(dim=1)
        # A column whose DOM_CHUNK tile starts at a non-finite objective 0
        # is skipped by the reference's lax.cond.
        live = torch.isfinite(so[0][:, (pos[:k] // DOM_CHUNK) * DOM_CHUNK])
        dominated[:, :k] = dom & live
    unsorted = torch.zeros_like(ok).scatter_(1, order, dominated)
    return ok & ~unsorted


def _carry_dominated_plain(carry_pts, objs):
    """(B, n) mask of lanes strictly dominated by a carried point.
    carry_pts: (CARRY_FRONT, d); objs: d (B, n) vectors (+inf where
    infeasible). +inf padding rows never dominate; exact ties survive."""
    le = lt = None
    for j, x in enumerate(objs):
        cj = carry_pts[:, j][None, :, None]
        xx = x[:, None, :]
        le = (cj <= xx) if le is None else le & (cj <= xx)
        lt = (cj < xx) if lt is None else lt | (cj < xx)
    return (le & lt).any(dim=1)


def _objective_codes(objectives) -> tuple:
    """Codes of `objectives` in PARETO_METRICS; refuses what the frontier
    kernels do not model (`util`) and any list the kernels cannot hold."""
    objectives = tuple(objectives)
    bad = [k for k in objectives if k not in PARETO_METRICS]
    if bad or not 1 <= len(objectives) <= len(PARETO_METRICS):
        raise ValueError(f"the frontier kernels minimize 1 to 5 of "
                         f"{PARETO_METRICS}, got {objectives!r}")
    return tuple(PARETO_METRICS.index(k) for k in objectives)


def _pareto_reduce_plain(workloads, objectives, has_carry: bool, c, cols,
                         valid, base, cons, carry) -> torch.Tensor:
    """(PARETO_ROWS * W, n_blocks) block-front reduction over lanes laid
    out as (n_blocks * BLOCK,) vectors; `base` holds each block's float32
    first global index."""
    _objective_codes(objectives)
    k, per_wl = _statics(workloads, c)
    n_blocks = valid.shape[0] // BLOCK
    dev = valid.device
    out = torch.empty((PARETO_ROWS * len(workloads), n_blocks),
                      dtype=torch.float32, device=dev)
    local = torch.arange(BLOCK, dtype=torch.int32, device=dev).float()
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    for w, (wl, gm) in enumerate(per_wl):
        area, power = _config_metrics_hw(k, wl, *cols)
        energy, latency = _config_metrics_wl(k, wl, gm, power, *cols)
        ok = (valid & (area < cons[w, 0]) & (power < cons[w, 1])
              & (energy < cons[w, 2]) & (latency < cons[w, 3]))
        vals = {"area": area, "power": power, "energy": energy,
                "latency": latency, "edp": energy * latency}
        objs = [vals[m].view(n_blocks, BLOCK) for m in objectives]
        ok = ok.view(n_blocks, BLOCK)
        carry_pts = carry[w * CARRY_FRONT:(w + 1) * CARRY_FRONT]
        r0 = PARETO_ROWS * w
        for s in range(0, n_blocks, PLAIN_BATCH):
            e = min(s + PLAIN_BATCH, n_blocks)
            ok_b = ok[s:e]
            ob = [x[s:e] for x in objs]
            front = _block_front_plain(ob, ok_b)
            if has_carry:
                front = front & ~_carry_dominated_plain(
                    carry_pts, [torch.where(ok_b, x, inf) for x in ob])
            key = torch.where(front, local, float(BLOCK)).sort(dim=1) \
                .values[:, :MAX_FRONT]
            out[r0, s:e] = front.sum(dim=1).float()
            out[r0 + 1, s:e] = ok_b.sum(dim=1).float()
            out[r0 + PARETO_HEADER:r0 + PARETO_ROWS, s:e] = torch.where(
                key < BLOCK, base[s:e, None] + key,
                torch.full_like(key, -1.0)).T
    return out


def dse_pareto_padded_plain(cfg_cols, mask, cons, carry, *,
                            workloads: tuple, objectives: tuple,
                            has_carry: bool = True,
                            constants: DeviceConstants) -> torch.Tensor:
    """Plain version of `dse_pareto_padded`: (130W, ceil(G / BLOCK))."""
    cfg_cols, mask = _pad_cols(cfg_cols, mask)
    n_blocks = cfg_cols.shape[1] // BLOCK
    base = (torch.arange(n_blocks, dtype=torch.int32, device=cfg_cols.device)
            * BLOCK).float()
    cols = tuple(cfg_cols[i] for i in range(5))
    return _pareto_reduce_plain(workloads, objectives, has_carry, constants,
                                cols, mask[0] > 0.0, base, cons, carry)


def dse_pareto_decoded_plain(axes, meta, cons, carry, *, radices: tuple,
                             n_blocks: int, workloads: tuple,
                             objectives: tuple, has_carry: bool = True,
                             constants: DeviceConstants) -> torch.Tensor:
    """Plain version of `dse_pareto_decoded`: (130W, n_blocks), BLOCK
    decoded lanes per block, global indices."""
    cols, idx, valid = _decode_block_plain(radices, axes, meta, n_blocks,
                                           BLOCK)
    base = idx.view(n_blocks, BLOCK)[:, 0]
    return _pareto_reduce_plain(workloads, objectives, has_carry, constants,
                                cols, valid, base, cons, carry)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _launch(device: torch.device, entry: str, *args) -> int:
    """Call the C entry point `entry` with `args` and the stream of
    `device`, with `device` current: the entry points read the SM count of,
    and set kernel attributes on, the current device, and a sharded search
    launches each shard on the card its operands lie on."""
    from ._build import load_library
    with torch.cuda.device(device):
        return getattr(load_library(), entry)(*args, _stream())


class KernelLaunchError(RuntimeError):
    """A hand-written kernel's launch returned a CUDA error. The resilient
    runtime retries it; a bare RuntimeError, a programming error, it never
    retries."""


class KernelNaN(RuntimeError):
    """A DSE kernel's reduction output held NaN. The metric pipelines never
    emit NaN (infeasible lanes reduce to +inf), so NaN there means a
    poisoned launch (bad memory, an injected fault); the host wrappers
    (`kernels.ops`) raise this instead of reducing it into a wrong answer,
    and the resilient runtime treats the unit as poisoned."""


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelLaunchError(f"{name} kernel launch failed: CUDA error "
                                f"{rc}")


def _require(tensors, dtypes, name: str) -> None:
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: every operand must be a contiguous "
                             f"{dt} tensor on {dev}, got {t.dtype} on "
                             f"{t.device} (contiguous={t.is_contiguous()})")


def _radix_args(radices, axes):
    r = tuple(int(x) for x in radices)
    if len(r) != 5 or min(r) < 1 or max(r) > axes.shape[1]:
        raise ValueError(f"radices {r} do not fit the (5, {axes.shape[1]}) "
                         f"axes operand")
    return [ctypes.c_int(x) for x in r]


def dse_eval_padded(cfg_cols: torch.Tensor, *, gemms: tuple,
                    wl_scalars: tuple,
                    constants: DeviceConstants) -> torch.Tensor:
    """cfg_cols: (5, G) float32, any G -> (4, G) [area, power, energy,
    latency]. Replaces `repro/kernels/dse_eval.py:dse_eval_padded`."""
    if not cfg_cols.is_cuda:
        return dse_eval_padded_plain(cfg_cols, gemms=gemms,
                                     wl_scalars=wl_scalars,
                                     constants=constants)
    from ._build import count_launch
    _require([cfg_cols], [torch.float32], "dse_eval_padded")
    g = cfg_cols.shape[1]
    params = _device_params(((gemms, wl_scalars),), constants,
                            cfg_cols.device)
    out = torch.empty((4, g), dtype=torch.float32, device=cfg_cols.device)
    rc = _launch(cfg_cols.device, "dse_eval_launch",
                 _ptr(cfg_cols), _ptr(out), ctypes.c_int(g), _ptr(params),
                 ctypes.c_int(params.numel()))
    _check(rc, "dse_eval_padded")
    count_launch(LAUNCHES, "dse_eval_padded")
    return out


def dse_search_padded(cfg_cols, mask, cons, carry, *, workloads: tuple,
                      constants: DeviceConstants) -> torch.Tensor:
    """Fused search over a (5, G) config grid, any G (same contract as
    `repro/kernels/dse_eval.py:dse_search_padded`).

    cfg_cols (5, G) float32; mask (1, G) float32 (0 = never counts); cons
    (W, 4) float32 [area, power, energy, latency] bounds; carry (W, 1)
    float32 best EDP carried in (+inf = none). Returns (3W, ceil(G/BLOCK))
    float32: per workload [best EDP, launch-local index or CARRY_IDX,
    feasible count] per block.
    """
    if not cfg_cols.is_cuda:
        return dse_search_padded_plain(cfg_cols, mask, cons, carry,
                                       workloads=workloads,
                                       constants=constants)
    from ._build import count_launch
    _require([cfg_cols, mask, cons, carry], [torch.float32] * 4,
             "dse_search_padded")
    g = cfg_cols.shape[1]
    w = len(workloads)
    if cons.shape != (w, 4) or carry.shape != (w, 1) or mask.shape != (1, g):
        raise ValueError("dse_search_padded: operand shapes disagree")
    n_blocks = max(1, math.ceil(g / BLOCK))
    params = _device_params(workloads, constants, cfg_cols.device)
    out = torch.empty((SEARCH_ROWS * w, n_blocks), dtype=torch.float32,
                      device=cfg_cols.device)
    rc = _launch(cfg_cols.device, "dse_search_padded_launch",
                 _ptr(cfg_cols), _ptr(mask), ctypes.c_int(g), _ptr(cons),
                 _ptr(carry), _ptr(params), ctypes.c_int(params.numel()),
                 _ptr(out), ctypes.c_int(n_blocks))
    _check(rc, "dse_search_padded")
    count_launch(LAUNCHES, "dse_search_padded")
    return out


def dse_search_decoded(axes, meta, cons, carry, *, radices: tuple,
                       n_blocks: int, workloads: tuple,
                       constants: DeviceConstants) -> torch.Tensor:
    """Fused search over the index span (and slab digit ranges) of the
    (META_COLS,) int32 meta row, configs decoded per lane from the
    (5, max_radix) float32 axes matrix; same output layout as
    `dse_search_padded` with global indices, DECODE_BLOCK lanes per block.
    Replaces `repro/kernels/dse_eval.py:dse_search_decoded`."""
    if not axes.is_cuda:
        return dse_search_decoded_plain(axes, meta, cons, carry,
                                        radices=radices, n_blocks=n_blocks,
                                        workloads=workloads,
                                        constants=constants)
    from ._build import count_launch
    _require([axes, meta, cons, carry],
             [torch.float32, torch.int32, torch.float32, torch.float32],
             "dse_search_decoded")
    w = len(workloads)
    if meta.shape != (META_COLS,) or cons.shape != (w, 4) \
            or carry.shape != (w, 1):
        raise ValueError("dse_search_decoded: operand shapes disagree")
    params = _device_params(workloads, constants, axes.device)
    out = torch.empty((SEARCH_ROWS * w, n_blocks), dtype=torch.float32,
                      device=axes.device)
    rc = _launch(axes.device, "dse_search_decoded_launch",
                 _ptr(axes), ctypes.c_int(axes.shape[1]), _ptr(meta),
                 *_radix_args(radices, axes), _ptr(cons), _ptr(carry),
                 _ptr(params), ctypes.c_int(params.numel()), _ptr(out),
                 ctypes.c_int(n_blocks))
    _check(rc, "dse_search_decoded")
    count_launch(LAUNCHES, "dse_search_decoded")
    return out


def dse_decode_rows(axes, meta, *, radices: tuple,
                    n_blocks: int) -> torch.Tensor:
    """(6, n_blocks * BLOCK) [five decoded config rows; validity] for the
    span + slab ranges of the meta row. Replaces
    `repro/kernels/dse_eval.py:dse_decode_rows`."""
    if not axes.is_cuda:
        return dse_decode_rows_plain(axes, meta, radices=radices,
                                     n_blocks=n_blocks)
    from ._build import count_launch
    _require([axes, meta], [torch.float32, torch.int32], "dse_decode_rows")
    if meta.shape != (META_COLS,):
        raise ValueError("dse_decode_rows: meta must be (META_COLS,) int32")
    out = torch.empty((6, n_blocks * BLOCK), dtype=torch.float32,
                      device=axes.device)
    rc = _launch(axes.device, "dse_decode_rows_launch",
                 _ptr(axes), ctypes.c_int(axes.shape[1]), _ptr(meta),
                 *_radix_args(radices, axes), _ptr(out),
                 ctypes.c_int(n_blocks))
    _check(rc, "dse_decode_rows")
    count_launch(LAUNCHES, "dse_decode_rows")
    return out


def _pareto_args(objectives, has_carry: bool, carry, w: int):
    """(d, packed objective codes, has_carry) launch arguments; the carry
    must be the (W * CARRY_FRONT, d) float32 operand."""
    codes = _objective_codes(objectives)
    if carry.shape != (w * CARRY_FRONT, len(codes)):
        raise ValueError(f"carry must be (W * CARRY_FRONT, d) = "
                         f"({w * CARRY_FRONT}, {len(codes)}), got "
                         f"{tuple(carry.shape)}")
    packed = sum(code << (3 * i) for i, code in enumerate(codes))
    return [ctypes.c_int(len(codes)), ctypes.c_int(packed),
            ctypes.c_int(int(bool(has_carry)))]


def dse_pareto_padded(cfg_cols, mask, cons, carry, *, workloads: tuple,
                      objectives: tuple, has_carry: bool = True,
                      constants: DeviceConstants) -> torch.Tensor:
    """Frontier-candidate reduction over a (5, G) config grid, any G (same
    contract as `repro/kernels/dse_eval.py:dse_pareto_padded`, which it
    replaces).

    cfg_cols (5, G), mask (1, G), cons (W, 4) and carry (W * CARRY_FRONT, d)
    float32; `objectives` names d of PARETO_METRICS; `has_carry=False`
    skips the carried-front prune. Returns (PARETO_ROWS * W,
    ceil(G / BLOCK)) float32: per workload, the block's true front count,
    its feasible count, then up to MAX_FRONT launch-local indices of its
    front in ascending order, -1 padded.
    """
    if not cfg_cols.is_cuda:
        return dse_pareto_padded_plain(cfg_cols, mask, cons, carry,
                                       workloads=workloads,
                                       objectives=objectives,
                                       has_carry=has_carry,
                                       constants=constants)
    from ._build import count_launch
    _require([cfg_cols, mask, cons, carry], [torch.float32] * 4,
             "dse_pareto_padded")
    g = cfg_cols.shape[1]
    w = len(workloads)
    if cons.shape != (w, 4) or mask.shape != (1, g):
        raise ValueError("dse_pareto_padded: operand shapes disagree")
    obj_args = _pareto_args(objectives, has_carry, carry, w)
    n_blocks = max(1, math.ceil(g / BLOCK))
    params = _device_params(workloads, constants, cfg_cols.device)
    out = torch.empty((PARETO_ROWS * w, n_blocks), dtype=torch.float32,
                      device=cfg_cols.device)
    rc = _launch(cfg_cols.device, "dse_pareto_padded_launch",
                 _ptr(cfg_cols), _ptr(mask), ctypes.c_int(g), _ptr(cons),
                 _ptr(carry), *obj_args, _ptr(params),
                 ctypes.c_int(params.numel()), _ptr(out),
                 ctypes.c_int(n_blocks))
    _check(rc, "dse_pareto_padded")
    count_launch(LAUNCHES, "dse_pareto_padded")
    return out


def dse_pareto_decoded(axes, meta, cons, carry, *, radices: tuple,
                       n_blocks: int, workloads: tuple, objectives: tuple,
                       has_carry: bool = True,
                       constants: DeviceConstants) -> torch.Tensor:
    """Frontier-candidate reduction over the span (and slab digit ranges)
    of the (META_COLS,) int32 meta row, BLOCK decoded lanes per block; same
    output layout as `dse_pareto_padded` with global indices. Replaces
    `repro/kernels/dse_eval.py:dse_pareto_decoded`."""
    if not axes.is_cuda:
        return dse_pareto_decoded_plain(axes, meta, cons, carry,
                                        radices=radices, n_blocks=n_blocks,
                                        workloads=workloads,
                                        objectives=objectives,
                                        has_carry=has_carry,
                                        constants=constants)
    from ._build import count_launch
    _require([axes, meta, cons, carry],
             [torch.float32, torch.int32, torch.float32, torch.float32],
             "dse_pareto_decoded")
    w = len(workloads)
    if meta.shape != (META_COLS,) or cons.shape != (w, 4):
        raise ValueError("dse_pareto_decoded: operand shapes disagree")
    obj_args = _pareto_args(objectives, has_carry, carry, w)
    params = _device_params(workloads, constants, axes.device)
    out = torch.empty((PARETO_ROWS * w, n_blocks), dtype=torch.float32,
                      device=axes.device)
    rc = _launch(axes.device, "dse_pareto_decoded_launch",
                 _ptr(axes), ctypes.c_int(axes.shape[1]), _ptr(meta),
                 *_radix_args(radices, axes), _ptr(cons), _ptr(carry),
                 *obj_args, _ptr(params), ctypes.c_int(params.numel()),
                 _ptr(out), ctypes.c_int(n_blocks))
    _check(rc, "dse_pareto_decoded")
    count_launch(LAUNCHES, "dse_pareto_decoded")
    return out
