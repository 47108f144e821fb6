"""Host wrappers around the DSE kernels (the port of `repro/kernels/ops.py`'s
DSE half, with "pallas" read as "cuda").

  * `dse_eval_grid` / `cuda_grid_search` — the (G, 4) metrics field and the
    legacy two-pass search built on it;
  * `dse_search_grid` / `dse_search_multi` — the fused single-pass search of
    W workloads over one materialized grid;
  * `dse_search_multi_factorized` / `dse_search_spans_factorized` — the same
    over index spans (optionally slab-masked) of a product space, configs
    decoded on device;
  * `dse_pareto_multi` / `dse_pareto_multi_factorized` /
    `dse_pareto_spans_factorized` — the frontier-candidate counterparts:
    per-block local fronts, merged into per-workload candidate index sets;
  * `decode_rows_device` — the on-device decode, as rows;
  * `ddot_matmul` / `photonic_matmul` — the photonic 4-bit GEMM simulation
    (quantize in plain torch, then the ddot_gemm kernel), the latter with
    the reference's straight-through-estimator gradient;
  * `flash_attention` — fused attention on (B, S, H, D) with GQA.

Each DSE wrapper takes `device=`: a CUDA device launches the kernels, "cpu"
runs their plain PyTorch versions (see `kernels/dse_eval.py`). The LM
wrappers run where their tensor operands lie; numpy operands go to
`device=` ("cuda" unless the caller names another). The reference's
power-of-two bucketing of launch widths existed only to bound JAX's jit
cache; the port's unsharded launches run exactly ceil(G / block) blocks,
which returns the same wrapper-level results (extra blocks are all-invalid
and reduce to the carry).

`shard=N` on the search and frontier wrappers (kernels 2, 3, 5 and 6) fans
the candidates out over the candidate mesh (`launch.mesh.shard_mesh`: up to
N cards, one device on the CPU): each shard is one launch on its own
device, and the per-block columns come back to the host in shard order.
The sharded layout is the reference's `shard_map` layout, block for block:
padded launches take a power-of-two block count per shard with no floor,
and return shard-local indices that the host rebases in int64; decoded
launches take ceil(count / k) lanes per shard bucketed to a power of two,
and emit global indices from each shard's base in its meta row. The
`_sharded_*` launchers take the device tuple itself, so the k-shard layout
also runs on one device given k times.
"""
from __future__ import annotations

import functools
import logging
import math

import numpy as np
import torch

from .._device import resolve_device
from ..core.arch_params import PTAConfig
from ..core.factorized import decode_digits, full_ranges
from ..core.performance_model import workload_statics
from ..core.photonic_model import CONSTANTS, DeviceConstants
from ..core.workload import Workload
from ..launch.mesh import shard_mesh
from . import ddot_gemm as _ddot
from . import dse_eval as _dse
from .flash_attention import flash_attention_bhsd
from .ref import quantize4

log = logging.getLogger("repro_torch.kernels")


def _cols(grid: np.ndarray, device) -> torch.Tensor:
    """(G, 5) rows -> (5, G) float32 config columns on `device`."""
    cols = np.ascontiguousarray(np.asarray(grid).T, np.float32)
    return torch.from_numpy(cols).to(device)


def dse_eval_grid(grid: np.ndarray, wl: Workload,
                  c: DeviceConstants = CONSTANTS, device=None) -> np.ndarray:
    """(G, 5) config grid -> (G, 4) float32 [area, power, energy, latency]
    through the dse_eval kernel."""
    dev = resolve_device(device)
    gemms, wl_scalars = workload_statics(wl, c)
    out = _dse.dse_eval_padded(_cols(grid, dev), gemms=gemms,
                               wl_scalars=wl_scalars, constants=c)
    return out.cpu().numpy().T


def _constraint_rows(constraints_seq) -> np.ndarray:
    """(W, 4) float32 [area, power, energy, latency] bounds."""
    return np.asarray([[cc.area_mm2, cc.power_w, cc.energy_j, cc.latency_s]
                       for cc in constraints_seq], np.float32)


def _search_carry_rows(carry_edp, w: int) -> np.ndarray:
    """(W, 1) float32 carried-best-EDP operand (+inf = no carry)."""
    arr = np.full((w, 1), np.inf, np.float32)
    if carry_edp is not None:
        arr[:, 0] = np.asarray(carry_edp, np.float64).astype(np.float32)
    return arr


def _front_carry_rows(carry_points, w: int, d: int) -> np.ndarray:
    """(W * CARRY_FRONT, d) float32 carried-front operand, +inf-padded.

    carry_points: per-workload (F, d) objective-point arrays (or None).
    Fronts longer than CARRY_FRONT are truncated — the kernel prune is a
    candidate filter, so carrying any subset stays exact.
    """
    cf = _dse.CARRY_FRONT
    arr = np.full((w * cf, d), np.inf, np.float32)
    if carry_points is not None:
        for wi, pts in enumerate(carry_points):
            if pts is None or len(pts) == 0:
                continue
            p = np.asarray(pts, np.float32)[:cf]
            arr[wi * cf:wi * cf + len(p)] = p
    return arr


def _to(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _has_carry(carry_points) -> bool:
    return carry_points is not None and any(
        p is not None and len(p) for p in carry_points)


def _check_finite(out: np.ndarray, what: str) -> None:
    """Raise `KernelNaN` on a NaN in a kernel's reduction output (already
    on the host): the block reductions below would otherwise drop a NaN
    lane (lexsort and `>= 0` pass it by) and return a wrong answer."""
    if np.isnan(out).any():
        raise _dse.KernelNaN(f"NaN in an output block of the {what}")


def _front_candidates(out: np.ndarray, w: int, blk_lo: np.ndarray,
                      limit: int, what: str, keep=None, col_base=None):
    """Per-workload (candidate indices, n_feasible, n_overflow) from a
    (PARETO_ROWS * W, n_blocks) frontier reduction. A block whose local
    front overflowed MAX_FRONT joins the candidates whole — [blk_lo,
    min(blk_lo + BLOCK, limit)), filtered by `keep` when given — so the
    emission bound never drops a frontier point; the caller's float64
    refinement restores the exact frontier. `col_base` rebases a sharded
    padded launch's shard-local indices, column by column."""
    _check_finite(out, what)
    results = []
    for wi in range(w):
        rows = out[_dse.PARETO_ROWS * wi:_dse.PARETO_ROWS * (wi + 1)]
        counts, nfeas_b = rows[0], rows[1]
        idx = rows[_dse.PARETO_HEADER:]
        base = 0 if col_base is None else col_base[None, :]
        cand = (idx.astype(np.int64) + base)[idx >= 0]
        overflowed = np.nonzero(counts > _dse.MAX_FRONT)[0]
        if len(overflowed):
            log.warning("%s: %d block(s) overflowed MAX_FRONT=%d; falling "
                        "back to whole-block candidates (exact, "
                        "host-refined)", what, len(overflowed),
                        _dse.MAX_FRONT)
        for b in overflowed:
            lo = int(blk_lo[b])
            fallback = np.arange(lo, min(lo + _dse.BLOCK, limit))
            if keep is not None:
                fallback = fallback[keep(fallback)]
            cand = np.concatenate([cand, fallback])
        results.append((np.unique(cand), int(round(float(nfeas_b.sum()))),
                        int(len(overflowed))))
    return results


def _reduce_blocks(out: np.ndarray, w: int, carry_edp, what: str,
                   col_base=None):
    """Per-workload (best_idx, best_edp, n_feasible) from the (3W, n_blocks)
    reduction: min EDP across blocks, ties to the lowest global index
    (CARRY_IDX sorts before every real index, so a carried tie wins).
    `col_base` rebases a sharded padded launch's shard-local indices in
    int64, column by column; the sentinels stay put."""
    _check_finite(out, what)
    best_idx, best_edp, n_feasible = [], [], []
    for wi in range(w):
        edp_b, idx_b, nf_b = out[_dse.SEARCH_ROWS * wi:
                                 _dse.SEARCH_ROWS * (wi + 1)]
        nf = int(round(float(nf_b.sum())))
        n_feasible.append(nf)
        if col_base is not None:
            idx_b = idx_b.astype(np.int64)
            idx_b = np.where(idx_b >= 0, idx_b + col_base, idx_b)
        jb = np.lexsort((idx_b, edp_b))[0]
        i = int(idx_b[jb])
        best_edp.append(float(edp_b[jb]))
        if nf == 0 and carry_edp is None:
            best_idx.append(-1)
            continue
        best_idx.append(i if i >= 0 else int(_dse.CARRY_IDX))
    return best_idx, best_edp, n_feasible


def _shard_blocks(count: int, k: int, block: int) -> int:
    """Blocks per shard of a k-shard launch over `count` lanes: ceil(count
    / k) lanes bucketed to a power-of-two block count with no floor (the
    reference's sharded layout)."""
    per_shard = -(-count // k)
    n_blocks = max(1, -(-per_shard // block))
    return 1 << (n_blocks - 1).bit_length()


def _gather(outs) -> np.ndarray:
    """The shards' per-block columns on the host, in shard order. Every
    shard was launched before the first copy waits, so the shards on
    different cards run at once."""
    return np.concatenate([o.cpu().numpy() for o in outs], axis=1)


def _sharded_padded(kind: str, grid: np.ndarray, devices, workloads: tuple,
                    c: DeviceConstants, cons: np.ndarray, carry: np.ndarray,
                    objectives=None, has_carry=False):
    """A k-shard padded launch (kernel 2 for kind "search", 5 for
    "pareto"), one per device of `devices` (k = its length): the candidate
    axis padded to k shards of a power-of-two number of BLOCK-lane blocks,
    all-ones padding configs masked invalid. Returns (out, shard_size,
    blocks_per_shard); the indices in `out` are shard-local, so column j's
    global base is (j // blocks_per_shard) * shard_size."""
    from ..parallel.sharding import (CANDIDATE_AXIS, candidate_spec,
                                     sanitize_spec)
    k = len(devices)
    g = np.asarray(grid)
    n = len(g)
    bps = _shard_blocks(n, k, _dse.BLOCK)
    shard_size = bps * _dse.BLOCK
    cols = np.ones((5, k * shard_size), np.float32)
    cols[:, :n] = g.T
    mask = np.zeros((1, k * shard_size), np.float32)
    mask[:, :n] = 1.0
    # The candidate axis was just padded to a k-multiple, so the spec can
    # never degrade; assert rather than carry an untestable fallback.
    spec = candidate_spec(2, 1)
    assert sanitize_spec(cols.shape, spec, {CANDIDATE_AXIS: k}) == spec
    outs = []
    for s, dev in enumerate(devices):
        part = slice(s * shard_size, (s + 1) * shard_size)
        args = (_to(cols[:, part], dev), _to(mask[:, part], dev),
                _to(cons, dev), _to(carry, dev))
        if kind == "search":
            outs.append(_dse.dse_search_padded(*args, workloads=workloads,
                                               constants=c))
        else:
            outs.append(_dse.dse_pareto_padded(
                *args, workloads=workloads, objectives=objectives,
                has_carry=has_carry, constants=c))
    return _gather(outs), shard_size, bps


def _shard_col_base(n_cols: int, shard_size: int, bps: int) -> np.ndarray:
    return (np.arange(n_cols, dtype=np.int64) // bps) * shard_size


def dse_search_grid(grid: np.ndarray, wl: Workload, constraints,
                    c: DeviceConstants = CONSTANTS, device=None, *,
                    shard=None, carry_edp=None):
    """Fused single-pass search: (best_idx, best_edp, n_feasible). best_idx
    is -1 when nothing is feasible, CARRY_IDX (-2) when the carried-in
    `carry_edp` beat (or tied) every feasible config."""
    best, edp, nf = dse_search_multi(
        grid, [wl], [constraints], c, device, shard=shard,
        carry_edp=None if carry_edp is None else [carry_edp])
    return best[0], edp[0], nf[0]


def dse_search_multi(grid: np.ndarray, wls, constraints_seq,
                     c: DeviceConstants = CONSTANTS, device=None, *,
                     shard=None, carry_edp=None):
    """Batched fused search: W workloads x one grid in a single launch (one
    per shard under `shard=`).

    Returns (best_idx_per_wl, best_edp_per_wl, n_feasible_per_wl) lists;
    best_idx is -1 when no config satisfies that workload's constraints
    (and no carry was given), CARRY_IDX (-2) when the carried-in best
    stands. n_feasible counts this grid only.
    """
    dev = resolve_device(device)
    workloads = tuple(workload_statics(wl, c) for wl in wls)
    cons = _constraint_rows(constraints_seq)
    carry = _search_carry_rows(carry_edp, len(workloads))
    mesh = shard_mesh(shard, dev)
    if mesh is not None:
        out, shard_size, bps = _sharded_padded("search", grid, mesh,
                                               workloads, c, cons, carry)
        return _reduce_blocks(out, len(workloads), carry_edp,
                              "search kernel",
                              _shard_col_base(out.shape[1], shard_size, bps))
    cols = _cols(grid, dev)
    mask = torch.ones((1, cols.shape[1]), dtype=torch.float32, device=dev)
    out = _dse.dse_search_padded(
        cols, mask, _to(cons, dev), _to(carry, dev), workloads=workloads,
        constants=c).cpu().numpy()
    return _reduce_blocks(out, len(workloads), carry_edp, "search kernel")


def dse_pareto_multi(grid: np.ndarray, wls, constraints_seq,
                     c: DeviceConstants = CONSTANTS, device=None,
                     objectives: tuple = ("area", "power", "edp"), *,
                     shard=None, carry_points=None):
    """Batched frontier-candidate search: W workloads x one grid, one launch.

    The kernel reduces every block to its local non-dominated feasible set
    (at most MAX_FRONT indices per block); this wrapper merges the
    per-block lists, taking every row of a block whose front overflowed.
    `carry_points` (per-workload (F, d) running-front points in the
    kernel's float32 metric space) prunes candidates a carried point
    strictly dominates. `shard=` launches once per shard, as
    `dse_search_multi`. Returns a list of (candidate_indices, n_feasible,
    n_overflow) per workload: sorted int64 grid rows covering the
    workload's feasible frontier as the kernel's float32 metrics see it,
    and the number of overflowed blocks.
    """
    dev = resolve_device(device)
    workloads = tuple(workload_statics(wl, c) for wl in wls)
    objectives = tuple(objectives)
    cons = _constraint_rows(constraints_seq)
    carry = _front_carry_rows(carry_points, len(workloads), len(objectives))
    has_carry = _has_carry(carry_points)
    mesh = shard_mesh(shard, dev)
    if mesh is not None:
        out, shard_size, bps = _sharded_padded(
            "pareto", grid, mesh, workloads, c, cons, carry, objectives,
            has_carry)
        col_base = _shard_col_base(out.shape[1], shard_size, bps)
        blk_lo = col_base + (np.arange(out.shape[1], dtype=np.int64)
                             % bps) * _dse.BLOCK
        return _front_candidates(out, len(workloads), blk_lo, len(grid),
                                 "pareto kernel", col_base=col_base)
    cols = _cols(grid, dev)
    mask = torch.ones((1, cols.shape[1]), dtype=torch.float32, device=dev)
    out = _dse.dse_pareto_padded(
        cols, mask, _to(cons, dev), _to(carry, dev), workloads=workloads,
        objectives=objectives, has_carry=has_carry,
        constants=c).cpu().numpy()
    blk_lo = np.arange(out.shape[1], dtype=np.int64) * _dse.BLOCK
    return _front_candidates(out, len(workloads), blk_lo, len(grid),
                             "pareto kernel")


# ---------------------------------------------------------------------------
# Factorized-space launches: on-device candidate generation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _axes_operand(space, device):
    """((5, max_radix) float32 candidate-value matrix, radices), resident on
    `device` once per space (a search's repeated launches share it). Short
    axes are padded with 1.0 — never selected by a valid lane, harmless if
    an invalid lane's clamped gather reads them."""
    radices = space.radices
    arr = np.ones((5, max(radices)), np.float32)
    for i, a in enumerate(space.axes):
        arr[i, :len(a)] = a
    return torch.from_numpy(arr).to(device), radices


def _meta_rows(radices, bases, limit: int, slab=None) -> np.ndarray:
    """(len(bases), META_COLS) int32 decode-kernel meta rows: [base, limit)
    plus the five [lo, hi) slab digit ranges (the whole-space ranges when
    `slab` is None — reducing the slab test to the plain span test)."""
    ranges = full_ranges(radices) if slab is None else tuple(slab)
    meta = np.zeros((len(bases), _dse.META_COLS), np.int32)
    meta[:, 0] = bases
    meta[:, 1] = limit
    for ax, (lo, hi) in enumerate(ranges):
        meta[:, 2 + 2 * ax] = lo
        meta[:, 3 + 2 * ax] = hi
    return meta


def _check_decode_span(limit: int):
    """The decode kernels emit *global* indices as float32, so any index at
    or past 2**24 would silently round to a neighboring config. Refuse
    instead of corrupting; spaces that big go through the numpy factorized
    engine (exact int64 indices)."""
    if limit > 1 << 24:
        raise ValueError(
            f"factorized cuda launches address configs by float32 global "
            f"index, exact only below 2**24; this span reaches {limit}. "
            f"Use the numpy factorized engine for larger spaces.")


def _slab_member_mask(radices, slab, idx: np.ndarray) -> np.ndarray:
    """Boolean mask of flat indices whose digits fall inside the slab."""
    digits = decode_digits(np.asarray(idx, np.int64), radices)
    ok = np.ones(len(idx), bool)
    for d, (lo, hi) in zip(digits, slab):
        ok &= (d >= lo) & (d < hi)
    return ok


def _decoded_one(kind: str, space, meta_row: np.ndarray, n_blocks: int,
                 workloads: tuple, c: DeviceConstants, cons: np.ndarray,
                 carry: np.ndarray, dev, objectives, has_carry):
    """Launch one decoded kernel (3 for kind "search", 6 for "pareto") on
    `dev` over the span of `meta_row`; returns its output tensor, not yet
    copied to the host."""
    axes_cols, radices = _axes_operand(space, dev)
    meta = _to(meta_row, dev)
    if kind == "search":
        return _dse.dse_search_decoded(axes_cols, meta, _to(cons, dev),
                                       _to(carry, dev), radices=radices,
                                       n_blocks=n_blocks,
                                       workloads=workloads, constants=c)
    return _dse.dse_pareto_decoded(axes_cols, meta, _to(cons, dev),
                                   _to(carry, dev), radices=radices,
                                   n_blocks=n_blocks, workloads=workloads,
                                   objectives=objectives,
                                   has_carry=has_carry, constants=c)


def _decoded_launch(space, start: int, count: int, kind: str,
                    workloads: tuple, c: DeviceConstants, cons, carry, dev,
                    slab=None, objectives=None, has_carry=False,
                    mesh=None):
    """A decoded launch over [start, start + count), optionally masked to a
    slab's digit ranges: kind "search" gives the (3W, n_blocks) reduction
    over DECODE_BLOCK-lane blocks, "pareto" the (PARETO_ROWS * W, n_blocks)
    frontier reduction over BLOCK-lane blocks (its dominance pass is
    quadratic in the block). On a `mesh` (a device tuple) it is one launch
    per shard: ceil(count / k) lanes a shard bucketed to a power-of-two
    block count, each shard's base in its own meta row. Returns (out, each
    block's first global index)."""
    radices = space.radices
    limit = min(start + count, space.size)
    _check_decode_span(limit)
    block = _dse.DECODE_BLOCK if kind == "search" else _dse.BLOCK
    if mesh is not None:
        bps = _shard_blocks(count, len(mesh), block)
        bases = start + np.arange(len(mesh)) * bps * block
        meta = _meta_rows(radices, bases, limit, slab)
        out = _gather([_decoded_one(kind, space, meta[s], bps, workloads, c,
                                    cons, carry, dev_s, objectives,
                                    has_carry)
                       for s, dev_s in enumerate(mesh)])
        blk_lo = (np.repeat(meta[:, 0].astype(np.int64), bps)
                  + np.tile(np.arange(bps, dtype=np.int64), len(mesh))
                  * block)
        return out, blk_lo
    n_blocks = max(1, math.ceil(count / block))
    meta = _meta_rows(radices, [start], limit, slab)[0]
    out = _decoded_one(kind, space, meta, n_blocks, workloads, c, cons,
                       carry, dev, objectives, has_carry)
    blk_lo = start + np.arange(n_blocks, dtype=np.int64) * block
    return out.cpu().numpy(), blk_lo


def dse_search_multi_factorized(space, start: int, count: int, wls,
                                constraints_seq,
                                c: DeviceConstants = CONSTANTS, device=None,
                                *, shard=None, carry_edp=None, slab=None):
    """Batched fused search over an index span of a product space.

    Same contract as `dse_search_multi` — (best_idx, best_edp, n_feasible)
    lists with the -1 / CARRY_IDX sentinels — except candidates live only
    on device (decoded from `space`) and `best_idx` is a global flat-space
    index. `slab` (five [lo, hi) digit ranges) masks the span's lanes to
    the slab's members in-kernel; `shard=` launches once per shard.
    """
    dev = resolve_device(device)
    workloads = tuple(workload_statics(wl, c) for wl in wls)
    out, _ = _decoded_launch(space, start, count, "search", workloads, c,
                             _constraint_rows(constraints_seq),
                             _search_carry_rows(carry_edp, len(workloads)),
                             dev, slab, mesh=shard_mesh(shard, dev))
    return _reduce_blocks(out, len(workloads), carry_edp,
                          "search decode kernel")


def dse_pareto_multi_factorized(space, start: int, count: int, wls,
                                constraints_seq,
                                c: DeviceConstants = CONSTANTS, device=None,
                                objectives: tuple = ("area", "power", "edp"),
                                *, shard=None, carry_points=None, slab=None):
    """Batched frontier-candidate search over an index span of a product
    space; same contract as `dse_pareto_multi` — (candidate_indices,
    n_feasible, n_overflow) triples — with global flat-space candidate
    indices. `slab` masks the span to a slab's members in-kernel, and an
    overflowing block's whole-block fallback is clipped back to the slab's
    members. `shard=` launches once per shard."""
    dev = resolve_device(device)
    workloads = tuple(workload_statics(wl, c) for wl in wls)
    objectives = tuple(objectives)
    out, blk_lo = _decoded_launch(
        space, start, count, "pareto", workloads, c,
        _constraint_rows(constraints_seq),
        _front_carry_rows(carry_points, len(workloads), len(objectives)),
        dev, slab, objectives, _has_carry(carry_points),
        shard_mesh(shard, dev))
    keep = None if slab is None else \
        functools.partial(_slab_member_mask, space.radices, slab)
    return _front_candidates(out, len(workloads), blk_lo,
                             min(start + count, space.size),
                             "pareto decode kernel", keep)


def dse_search_spans_factorized(space, items, wls, constraints_seq,
                                c: DeviceConstants = CONSTANTS, device=None,
                                *, shard=None, carry_edp=None):
    """Compose `dse_search_multi_factorized` launches over a work list of
    (start, count, slab) triples in ascending index order. Each workload's
    running best EDP rides between launches through the kernels' carry
    operand, so exact ties keep the earlier item's winner. Returns
    (best_idx, best_edp, n_feasible) lists; best_idx is -1 when nothing was
    feasible anywhere (or CARRY_IDX when only the caller's carry stands)."""
    w = len(wls)
    carry = list(carry_edp) if carry_edp is not None \
        else [float("inf")] * w
    best_idx = [-1 if carry_edp is None else int(_dse.CARRY_IDX)] * w
    best_edp = list(carry)
    n_feasible = [0] * w
    for start, count, slab in items:
        bi, be, bn = dse_search_multi_factorized(
            space, start, count, wls, constraints_seq, c, device,
            shard=shard, carry_edp=carry, slab=slab)
        for wi in range(w):
            n_feasible[wi] += bn[wi]
            if bi[wi] >= 0:  # beat the carry (ties stay with the carry)
                best_idx[wi], best_edp[wi] = bi[wi], be[wi]
                carry[wi] = be[wi]
    return best_idx, best_edp, n_feasible


def dse_pareto_spans_factorized(space, items, wls, constraints_seq,
                                c: DeviceConstants = CONSTANTS, device=None,
                                objectives: tuple = ("area", "power", "edp"),
                                *, shard=None, carry_points=None):
    """Compose `dse_pareto_multi_factorized` launches over a work list of
    (start, count, slab) triples: per-workload (candidate-index union,
    summed feasible count, summed overflow count) triples. `carry_points`
    (the running front at entry) prunes every launch's emissions;
    candidates of earlier items are not folded into the carry — the union
    is a candidate superset either way, and the caller's float64
    refinement restores exactness."""
    w = len(wls)
    cands = [[] for _ in range(w)]
    n_feasible = [0] * w
    n_overflow = [0] * w
    for start, count, slab in items:
        per_wl = dse_pareto_multi_factorized(
            space, start, count, wls, constraints_seq, c, device,
            objectives=objectives, shard=shard, carry_points=carry_points,
            slab=slab)
        for wi, (idx, f, n_over) in enumerate(per_wl):
            n_feasible[wi] += f
            n_overflow[wi] += n_over
            if len(idx):
                cands[wi].append(idx)
    return [(np.unique(np.concatenate(cc)) if cc
             else np.zeros(0, np.int64), f, o)
            for cc, f, o in zip(cands, n_feasible, n_overflow)]


def decode_rows_device(space, start: int, count: int, device=None,
                       slab=None) -> np.ndarray:
    """(count, 5) int64 rows of space.to_grid()[start:start+count], decoded
    on device by the decode kernel. With `slab`, only the span's
    slab-member lanes survive the validity mask."""
    dev = resolve_device(device)
    axes_cols, radices = _axes_operand(space, dev)
    n_blocks = max(1, -(-count // _dse.BLOCK))
    limit = min(start + count, space.size)
    _check_decode_span(limit)
    meta = _to(_meta_rows(radices, [start], limit, slab)[0], dev)
    out = _dse.dse_decode_rows(axes_cols, meta, radices=radices,
                               n_blocks=n_blocks).cpu().numpy()
    return out[:5, out[5] > 0.0].T.astype(np.int64)


def cuda_grid_search(grid: np.ndarray, wl: Workload, constraints,
                     c: DeviceConstants = CONSTANTS, device=None):
    """Legacy two-pass kernel path: the full (G, 4) metrics on the host,
    then a numpy select (mirrors grid_search_vectorized's rule). Kept as the
    baseline the fused `dse_search_grid` is measured against; prefer
    `core.search.search(..., engine="cuda")` for real searches."""
    m = dse_eval_grid(grid, wl, c, device)
    area, power, energy, latency = m.T
    ok = constraints.satisfied(area, power, energy, latency)
    edp = np.where(ok, energy * latency, np.inf)
    if not np.isfinite(edp).any():
        return None, m
    i = int(np.argmin(edp))
    return PTAConfig.from_array(grid[i]), m


# ---------------------------------------------------------------------------
# Photonic DDot GEMM (4-bit functional simulation) and fused attention
# ---------------------------------------------------------------------------

def _operand(x, device) -> torch.Tensor:
    """A tensor operand stays where it lies unless `device` names another
    place; a numpy operand goes to `device` ("cuda" by default)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x, device=resolve_device(device))


def ddot_matmul(a, b, *, noise_rms: float = 0.0, generator=None,
                device=None) -> torch.Tensor:
    """Photonic-PTA simulated matmul: a (M, K) @ b (K, N) -> (M, N) float32.

    Both operands are quantized to symmetric 4 bits (per row of a, per
    column of b) in plain torch, then multiplied exactly by the ddot_gemm
    kernel, any shape (the kernel masks its ragged edges, where the
    reference pads with zeros). With noise_rms > 0 the shot-noise draws
    come from `generator` (a torch.Generator on the operands' device): they
    are not `jax.random`'s draws, so noise compares by distribution only.
    Exact against `ref.ddot_matmul_ref` when noise_rms == 0.
    """
    a, b = _operand(a, device), _operand(b, device)
    qa, sa = quantize4(a, axis=1)
    qb, sb = quantize4(b, axis=0)
    z = None
    if noise_rms > 0.0:
        if generator is None:
            raise ValueError("noise_rms > 0 requires a torch.Generator")
        z = torch.randn((a.shape[0], b.shape[1]), generator=generator,
                        device=a.device, dtype=torch.float32)
    # qb keeps its layout: a transposed view (the LM head's `table.T`)
    # quantizes to a transposed int8 operand, which the kernel reads K-major
    # without a copy
    return _ddot.ddot_gemm_quantized(
        qa.to(torch.int8).contiguous(), qb.to(torch.int8),
        sa.contiguous(), sb.contiguous(), z, noise_rms=noise_rms)


class _PhotonicMatmul(torch.autograd.Function):
    """4-bit photonic forward, straight-through-estimator backward: the
    gradients are those of the full-precision product (`g @ b.T`,
    `a.T @ g`), as for QAT through hard quantizers."""

    @staticmethod
    def forward(ctx, a, b, noise_rms, key_data):
        ctx.save_for_backward(a, b)
        gen = None
        if noise_rms > 0.0:
            gen = torch.Generator(device=a.device)
            gen.manual_seed(int(key_data))
        return ddot_matmul(a, b, noise_rms=noise_rms, generator=gen)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.to(g.dtype).T).to(a.dtype)
        gb = (a.to(g.dtype).T @ g).to(b.dtype)
        return ga, gb, None, None


def photonic_matmul(a, b, noise_rms: float = 0.0, key_data: int = 0, *,
                    device=None) -> torch.Tensor:
    """`ddot_matmul` with the STE gradient; the noise generator is seeded
    with `key_data` on the operands' device (the reference's
    `jax.random.key(key_data)`)."""
    return _PhotonicMatmul.apply(_operand(a, device), _operand(b, device),
                                 float(noise_rms), int(key_data))


def _rup(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 128,
                    bk: int = 128, device=None) -> torch.Tensor:
    """Fused attention for (B, S, H, D) tensors with GQA support, through
    the flash_attention_bhsd kernel; the reference wrapper's contract.

    K/V with fewer heads than Q serve `H // Hkv` query heads each (the
    kernel reads KV head h // g, the reference repeats K/V); sequences are
    zero-padded to multiples of min(bq, S rounded up to 8) and min(bk, ...)
    as the reference pads, so padded keys are masked by the causal mask;
    bidirectional attention over a padded key tail raises ValueError.
    """
    q, k, v = (_operand(x, device) for x in (q, k, v))
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads do not split "
                         f"into groups over {hkv} KV heads")
    bq_ = min(bq, _rup(sq, 8))
    bk_ = min(bk, _rup(skv, 8))
    pq = (-sq) % bq_
    pk = (-skv) % bk_
    if pk and not causal:
        raise ValueError("bidirectional flash_attention requires "
                         f"skv % {bk_} == 0 (got {skv})")

    def to_bhsd(x, h, pad):
        x = x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d)
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        return x.contiguous()

    out = flash_attention_bhsd(to_bhsd(q, hq, pq), to_bhsd(k, hkv, pk),
                               to_bhsd(v, hkv, pk), causal=causal,
                               group=hq // hkv)
    return out[:, :sq].reshape(b, hq, sq, d).permute(0, 2, 1, 3)
