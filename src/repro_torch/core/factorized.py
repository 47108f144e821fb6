"""Factorized axis-table evaluation of a product config space.

The port's copy of `repro.core.factorized` (host side, numpy): the
product-space description (`FactorizedSpace`), its mixed-radix decode, the
float64 axis-table combine that is the numpy factorized engine, and the
slab utilities, admissible interval bounds and slab ledger
(`SlabLedger`, `LedgerRecorder`) of the branch-and-bound search. The hot
term of the cost model factors over low-rank slices of the
space:

  gemm_cycles = ceil(M / (N_t*N_h)) * ceil(N / N_v) * ceil(K / (N_c*N_l))

so a |T|*|C|*|V|*|H|*|L|-point sweep holds only |T|*|H| + |V| + |C|*|L|
distinct ceil-divisions per GEMM. The combine replays `eval_wload_arrays`'
float operations per element, in the same order, on the same values, so it
is bit-identical to evaluating the materialized grid.

Grid-order convention: `arch_params.config_grid` builds the product with
meshgrid axes (t, c, v, h, lambda) — N_t slowest, N_lambda fastest — but
*column* order (n_t, n_c, n_h, n_v, n_lambda). `FactorizedSpace` stores the
candidate sets in meshgrid axis order and `decode()` reproduces
`config_grid` rows for any flat-index range (the CUDA decode kernel of
`kernels/dse_eval.py` decodes on device with the same `decode_digits`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from .arch_params import config_grid
from .performance_model import (_ceil_div, cycle_factor_tables,
                                workload_tail_tensors)
from .photonic_model import CONSTANTS, DeviceConstants, eval_hw

# Meshgrid axis order of the product space (see config_grid): N_t slowest,
# N_lambda fastest. Note V before H — but column order is (t, c, h, v, l).
AXIS_NAMES = ("n_t", "n_c", "n_v", "n_h", "n_lambda")


@dataclasses.dataclass(frozen=True)
class FactorizedSpace:
    """A product config space: five candidate-value tuples in meshgrid axis
    order (t, c, v, h, lambda). Hashable, so it keys caches directly."""

    axes: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        if len(self.axes) != 5 or any(len(a) == 0 for a in self.axes):
            raise ValueError("FactorizedSpace needs five non-empty "
                             f"candidate sets, got {self.axes!r}")
        if any(v < 1 for a in self.axes for v in a):
            raise ValueError("candidate values are parallelism degrees and "
                             f"must all be >= 1, got {self.axes!r}")

    @staticmethod
    def from_space(space) -> "FactorizedSpace":
        """From a candidate-set mapping with build_search_space's keys."""
        if isinstance(space, FactorizedSpace):
            return space
        if isinstance(space, Mapping):
            return FactorizedSpace(tuple(
                tuple(int(v) for v in space[k]) for k in AXIS_NAMES))
        if isinstance(space, Sequence) and len(space) == 5:
            return FactorizedSpace(tuple(
                tuple(int(v) for v in a) for a in space))
        raise ValueError(f"cannot build a FactorizedSpace from {space!r}")

    @staticmethod
    def full(n_z: int) -> "FactorizedSpace":
        """The paper's full 1..n_z product space (n_z^5 configurations)."""
        inc = tuple(range(1, int(n_z) + 1))
        return FactorizedSpace((inc,) * 5)

    @property
    def radices(self) -> Tuple[int, ...]:
        """Per-axis candidate counts, in meshgrid axis order."""
        return tuple(len(a) for a in self.axes)

    @property
    def size(self) -> int:
        """Total number of grid points (product of the radices)."""
        return math.prod(self.radices)

    def to_grid(self) -> np.ndarray:
        """Materialize the full (G, 5) grid (tests / reference use only)."""
        return config_grid(*[list(a) for a in self.axes])

    def decode(self, idx) -> np.ndarray:
        """Flat indices -> (n, 5) int64 rows, identical to to_grid()[idx]."""
        d = decode_digits(np.asarray(idx, np.int64), self.radices)
        a = [np.asarray(ax, np.int64) for ax in self.axes]
        # Column order (n_t, n_c, n_h, n_v, n_lambda): h is meshgrid axis 3,
        # v is axis 2 (mirrors config_grid's column gather).
        return np.stack([a[0][d[0]], a[1][d[1]], a[3][d[3]], a[2][d[2]],
                         a[4][d[4]]], axis=1)

    def rows(self, start: int, stop: int) -> np.ndarray:
        """The contiguous slice to_grid()[start:stop] without the grid."""
        return self.decode(np.arange(start, stop, dtype=np.int64))


def decode_digits(idx, radices):
    """Mixed-radix decode of flat grid indices into per-axis digit arrays.

    Returns (d_t, d_c, d_v, d_h, d_l) in meshgrid axis order: the flat
    index of config_grid factors as
    ((((d_t * C + d_c) * V + d_v) * H + d_h) * L + d_l.
    Plain `%` and `//` on non-negative integers, so it takes numpy arrays
    (int64 on the host) and torch integer tensors (the int32 lanes of the
    plain version of the CUDA decode) alike.
    """
    t_r, c_r, v_r, h_r, l_r = (int(r) for r in radices)
    i = idx
    d_l = i % l_r
    i = i // l_r
    d_h = i % h_r
    i = i // h_r
    d_v = i % v_r
    i = i // v_r
    d_c = i % c_r
    d_t = i // c_r
    return d_t, d_c, d_v, d_h, d_l


def axis_cycle_tables(axes, gemm_array):
    """Per-GEMM factor tables over a product space's axes.

    Returns (f_m, f_n, f_k) int64 arrays of shape (W, T, H), (W, V) and
    (W, C, L): every distinct value the three ceil-division factors of
    `gemm_cycles` take over the space.
    """
    t, c_, v, h, lam = (np.asarray(np.asarray(a, np.int32)) for a in axes)
    d_m = (t[:, None] * h[None, :]).reshape(-1)
    d_k = (c_[:, None] * lam[None, :]).reshape(-1)
    f_m, f_n, f_k = cycle_factor_tables(gemm_array, d_m, v, d_k)
    w = f_m.shape[0]
    return (f_m.reshape(w, len(t), len(h)), f_n,
            f_k.reshape(w, len(c_), len(lam)))


def _space_cols(axes, digits=None):
    """(n_t, n_c, n_h, n_v, n_lambda) int64 config-column arrays: 5-D
    broadcast views over the meshgrid axes (digits=None), or gathered per
    decoded digit vector."""
    t, c_, v, h, lam = (np.asarray(a, np.int64) for a in axes)
    if digits is None:
        return (t[:, None, None, None, None], c_[None, :, None, None, None],
                h[None, None, None, :, None], v[None, None, :, None, None],
                lam[None, None, None, None, :])
    d_t, d_c, d_v, d_h, d_l = digits
    return t[d_t], c_[d_c], h[d_h], v[d_v], lam[d_l]


def evaluate_space(axes, gemm_array, elec_ops, weight_bytes, act_io_bytes,
                   sram_mb, c: DeviceConstants = CONSTANTS, idx=None):
    """Float64 factorized metrics over a product space — the axis-table
    combine.

    idx=None evaluates the whole space, flattened in config_grid order; an
    integer array evaluates those flat indices (mixed-radix decode + table
    gathers). Returns the `evaluate_grid` dict: area, power, energy,
    latency, util, edp — bit-identical per element to evaluating the
    materialized rows.
    """
    radices = tuple(len(a) for a in axes)
    f_m, f_n, f_k = axis_cycle_tables(axes, gemm_array)
    g = np.asarray(gemm_array)
    m, k, n = g[:, 0], g[:, 1], g[:, 2]
    count = g[:, 3] * 1.0

    if idx is None:
        cols = _space_cols(axes)
        # (T, C, V, H, L, W) per-GEMM cycles: the same ((f_m*f_n)*f_k)*count
        # product chain gemm_cycles computes per config, GEMM axis last.
        a_b = np.transpose(f_m * 1.0, (1, 2, 0))[:, None, None, :, None, :]
        b_b = np.transpose(f_n * 1.0, (1, 0))[None, None, :, None, None, :]
        c_b = np.transpose(f_k * 1.0, (1, 2, 0))[None, :, None, None, :, :]
        cyc = a_b * b_b * c_b * count
    else:
        digits = decode_digits(np.asarray(idx), radices)
        d_t, d_c, d_v, d_h, d_l = digits
        cols = _space_cols(axes, digits)
        a_i = (f_m * 1.0)[:, d_t, d_h]               # (W, n)
        b_i = (f_n * 1.0)[:, d_v]
        c_i = (f_k * 1.0)[:, d_c, d_l]
        cyc = np.transpose(a_i * b_i * c_i * count[:, None], (1, 0))

    n_t, n_c, n_h, n_v, n_l = cols
    total_cycles = np.sum(cyc, axis=-1)
    macs = np.sum((m * 1.0) * (k * 1.0) * (n * 1.0) * count)
    peak_macs = n_t * n_h * n_v * n_c * n_l
    util = macs / np.maximum(total_cycles * peak_macs, 1.0)

    t_photonic = total_cycles / c.f_clk_hz
    t_mem = (weight_bytes + act_io_bytes) / c.dram_bw_bytes
    t_elec = elec_ops / c.elec_ops_per_s
    latency = np.maximum(t_photonic, t_mem) + t_elec

    area, power = eval_hw(n_t, n_c, n_h, n_v, n_l, sram_mb, c)
    lanes = (n_t * n_h + n_v) * n_c * n_l
    sram_bytes = np.sum(cyc * lanes[..., None], axis=-1) * c.act_bits / 8.0
    energy = (power * latency
              + c.e_dram_per_byte * (weight_bytes + act_io_bytes)
              + c.e_sram_per_byte * sram_bytes)

    out = {"area": area, "power": power, "energy": energy,
           "latency": latency, "util": util, "edp": energy * latency}
    if idx is None:
        out = {key: np.reshape(np.broadcast_to(v, radices), (-1,))
               for key, v in out.items()}
    return out


def evaluate_space_tensors(axes, gemm_t, elec_ops, weight_bytes,
                           act_io_bytes, sram_mb,
                           c: DeviceConstants = CONSTANTS, idx=None):
    """Float32 factorized metrics on `gemm_t`'s device (the torch engine):
    `evaluate_space(..., xp=jnp, col_dtype=np.float32)` of the reference.

    gemm_t is the (W, 4) int32 `performance_model.gemm_tensor`; idx None
    evaluates the whole space by the broadcast combine, an integer tensor
    those flat indices by decode and table gathers. Returns the
    `evaluate_grid` dict of float32 tensors, each element the value the
    per-config float32 model gives that config.
    """
    dev = gemm_t.device
    radices = tuple(len(a) for a in axes)
    t, c_, v, h, lam = (torch.from_numpy(np.asarray(a, np.int32)).to(dev)
                        for a in axes)
    m, k, n = gemm_t[:, 0], gemm_t[:, 1], gemm_t[:, 2]
    f_m = _ceil_div(m[:, None], (t[:, None] * h[None, :]).reshape(1, -1))
    f_n = _ceil_div(n[:, None], v[None, :])
    f_k = _ceil_div(k[:, None], (c_[:, None] * lam[None, :]).reshape(1, -1))
    w = f_m.shape[0]
    f_m = f_m.reshape(w, len(t), len(h)) * 1.0
    f_n = f_n * 1.0
    f_k = f_k.reshape(w, len(c_), len(lam)) * 1.0
    count = gemm_t[:, 3] * 1.0
    t, c_, v, h, lam = (x.float() for x in (t, c_, v, h, lam))
    if idx is None:
        cols = (t[:, None, None, None, None], c_[None, :, None, None, None],
                h[None, None, None, :, None], v[None, None, :, None, None],
                lam[None, None, None, None, :])
        a_b = f_m.permute(1, 2, 0)[:, None, None, :, None, :]
        b_b = f_n.permute(1, 0)[None, None, :, None, None, :]
        c_b = f_k.permute(1, 2, 0)[None, :, None, None, :, :]
        cyc = a_b * b_b * c_b * count
    else:
        d_t, d_c, d_v, d_h, d_l = decode_digits(idx.long(), radices)
        cols = t[d_t], c_[d_c], h[d_h], v[d_v], lam[d_l]
        cyc = (f_m[:, d_t, d_h] * f_n[:, d_v] * f_k[:, d_c, d_l]
               * count[:, None]).T
    area, power = eval_hw(*cols, sram_mb, c)
    energy, latency, util = workload_tail_tensors(
        cols, cyc, power, gemm_t, elec_ops, weight_bytes, act_io_bytes, c)
    out = {"area": area, "power": power, "energy": energy,
           "latency": latency, "util": util, "edp": energy * latency}
    if idx is None:
        out = {key: torch.broadcast_to(x, radices).reshape(-1)
               for key, x in out.items()}
    return out


def factorized_evaluate_grid(fspace: FactorizedSpace, wl,
                             c: DeviceConstants = CONSTANTS, idx=None):
    """Float64 reference combiner: `evaluate_grid(fspace.to_grid()[idx])`
    without materializing any rows — bit-identical output (the numpy
    factorized engine)."""
    from .photonic_model import sram_mb_for_workload
    sram_mb = sram_mb_for_workload(wl.max_act_bytes, c)
    return evaluate_space(fspace.axes, wl.gemm_array, wl.elec_ops,
                          wl.weight_bytes, wl.act_io_bytes, sram_mb, c,
                          idx=idx)


# ---------------------------------------------------------------------------
# Slabs: mixed-radix sub-boxes of a product space (the branch-and-bound unit)
# ---------------------------------------------------------------------------
#
# A *slab* is a per-axis tuple of [lo, hi) digit ranges in meshgrid axis
# order (t, c, v, h, lambda) — the Cartesian sub-box of the product space
# those digit ranges span. The bound-guided search (core.search,
# prune="bound") recursively splits the space into slabs, prices each slab
# with the interval lower bounds below, and only the slabs it cannot prune
# ever reach a per-point evaluator.

def full_ranges(radices) -> Tuple[Tuple[int, int], ...]:
    """The whole-space slab: every axis's full [0, radix) digit range."""
    return tuple((0, int(r)) for r in radices)


def slab_size(ranges) -> int:
    """Number of grid points inside one slab (product of range widths)."""
    return math.prod(hi - lo for lo, hi in ranges)


def slab_bounding_span(radices, ranges) -> Tuple[int, int]:
    """[start, end) of the smallest contiguous flat-index range covering the
    slab (its first and last member in grid order). Equals the slab exactly
    when the restricted axes form a meshgrid prefix; otherwise the range
    contains interleaved non-members — the CUDA decode kernel masks those
    out per lane via the slab digit-range operand."""
    start = 0
    last = 0
    for (lo, hi), r in zip(ranges, radices):
        start = start * int(r) + int(lo)
        last = last * int(r) + int(hi) - 1
    return start, last + 1


def slab_spans(radices, ranges):
    """The slab's flat-index set as a list of maximal contiguous
    [start, count) runs in ascending grid order. One run per combination of
    restricted outer digits: with the calibrated significance order the
    restricted axes are the outermost meshgrid axes and a slab is a single
    span; arbitrary splits fragment into more runs."""
    import itertools
    radices = tuple(int(r) for r in radices)
    k = len(ranges) - 1
    while k >= 0 and ranges[k] == (0, radices[k]):
        k -= 1
    if k < 0:
        return [(0, math.prod(radices))]
    strides = [1] * 5
    for i in range(3, -1, -1):
        strides[i] = strides[i + 1] * radices[i + 1]
    run = (ranges[k][1] - ranges[k][0]) * strides[k]
    outer = [range(lo, hi) for lo, hi in ranges[:k]]
    spans = []
    for digits in itertools.product(*outer):
        base = sum(d * strides[j] for j, d in enumerate(digits))
        spans.append((base + ranges[k][0] * strides[k], run))
    spans.sort()
    merged = []
    for s, n in spans:
        if merged and merged[-1][0] + merged[-1][1] == s:
            merged[-1][1] += n
        else:
            merged.append([s, n])
    return [(s, n) for s, n in merged]


def slab_indices(radices, ranges) -> np.ndarray:
    """Ascending int64 flat indices of every slab member (the gather-form
    work list the numpy bound-guided engine evaluates per leaf)."""
    radices = tuple(int(r) for r in radices)
    idx = np.zeros((1,) * 5, np.int64)
    for i, (lo, hi) in enumerate(ranges):
        shape = [1] * 5
        shape[i] = hi - lo
        stride = math.prod(radices[i + 1:])
        idx = idx + (np.arange(lo, hi, dtype=np.int64)
                     * stride).reshape(shape)
    return idx.reshape(-1)


def slab_indices_batch(radices, ranges_list) -> np.ndarray:
    """Sorted int64 flat indices of the union of many slabs.

    A slab's index set is `base + pattern` where the pattern depends only
    on the per-axis *widths* (and the radices) and the base only on the
    per-axis starts — so slabs are grouped by width shape and each group
    expands as one (B, P) broadcast add instead of B separate little
    5-D broadcasts. The bound-guided evaluation batches are thousands of
    near-identical fine slabs, which is exactly this shape."""
    radices = tuple(int(r) for r in radices)
    strides = np.ones(5, np.int64)
    for i in range(3, -1, -1):
        strides[i] = strides[i + 1] * radices[i + 1]
    arr = np.asarray(ranges_list, np.int64).reshape(-1, 5, 2)
    if not len(arr):
        return np.zeros(0, np.int64)
    bases = arr[:, :, 0] @ strides
    groups, group_of = np.unique(arr[:, :, 1] - arr[:, :, 0], axis=0,
                                 return_inverse=True)
    group_of = group_of.reshape(-1)
    parts = []
    for g, widths in enumerate(groups):
        pattern = slab_indices(radices, tuple((0, int(w)) for w in widths))
        parts.append((bases[group_of == g][:, None]
                      + pattern[None, :]).reshape(-1))
    return np.sort(np.concatenate(parts))


class SlabBoundEvaluator:
    """Sound per-slab lower bounds on every report metric of a product space.

    The bounds replay `evaluate_space`'s float operations in interval
    arithmetic: each of the three per-GEMM cycle factors and each config
    column is replaced by its extremum over the slab's per-axis candidate
    subsets (min/max over the precomputed `axis_cycle_tables` sub-blocks),
    and the remaining arithmetic runs the *same ops on the same shapes in
    the same order* as the per-point combine. Every op is monotone in each
    operand over the non-negative inputs the model produces (IEEE
    multiply/add/divide/max round monotonically), so by induction the
    result is <= the metric of every enumerated slab point *in the same
    dtype's arithmetic* — bounds are sound by construction, not by
    tolerance. A width-1 slab degenerates to the exact point evaluation
    (bit-identical to `factorized_evaluate_grid` in float64).

    Latency/energy/EDP mix both corners — cycle factors are minimized at
    each axis's largest divisor while area/power/lanes are minimized at the
    smallest candidate values — which is exactly what makes the bound
    admissible for *every* point of the slab rather than any single corner.
    `util`'s lower bound needs the opposite extrema (it shrinks as cycles
    and peak MACs grow), so the tables carry max forms too.
    """

    def __init__(self, axes, gemm_array, elec_ops, weight_bytes,
                 act_io_bytes, sram_mb, c: DeviceConstants = CONSTANTS,
                 dtype=np.float64):
        self.dtype = np.dtype(dtype)
        self.c = c
        self.axes = tuple(np.asarray(a, np.int64) for a in axes)
        f_m, f_n, f_k = axis_cycle_tables(axes, gemm_array)
        self.f_m, self.f_n, self.f_k = f_m, f_n, f_k
        g = np.asarray(gemm_array)
        d = self.dtype
        # Workload statics, replayed once in the target dtype exactly as
        # evaluate_space computes them per call.
        m, k, n = g[:, 0].astype(d), g[:, 1].astype(d), g[:, 2].astype(d)
        self.count = (g[:, 3].astype(d) * d.type(1.0))
        self.macs = np.sum((m * 1.0) * (k * 1.0) * (n * 1.0) * self.count)
        self.t_mem = float(weight_bytes + act_io_bytes) / c.dram_bw_bytes
        self.t_elec = float(elec_ops) / c.elec_ops_per_s
        self.dram_j = c.e_dram_per_byte * float(weight_bytes + act_io_bytes)
        self.sram_mb = float(sram_mb)
        # Interval-extremum caches: the branch-and-bound recursion halves
        # ranges, so only O(radix) distinct intervals per axis (and
        # interval *pairs* per 2-axis table) ever occur — memoizing their
        # extrema makes a batched bound evaluation pure lookups plus one
        # vectorized arithmetic pass.
        self._col_ext: Dict = {}
        self._fm_ext: Dict = {}
        self._fn_ext: Dict = {}
        self._fk_ext: Dict = {}
        # Eager dyadic-interval tables (built on first batched call):
        # the branch-and-bound halving only ever produces the ~2R dyadic
        # intervals of each axis, so tabulating those extrema up front
        # makes a batch price pure vectorized lookups — zero per-slab
        # python. Non-dyadic ranges (arbitrary test slabs) fall back to
        # the memoized per-slab path, same arithmetic either way.
        self._eager = None

    def _build_eager(self):
        radices = tuple(len(a) for a in self.axes)

        def dyadic(r):
            """The halving tree of [0, r) — exactly the intervals
            core.search's _bnb_split can generate, mid = (lo + hi) // 2."""
            out = []
            stack = [(0, r)]
            while stack:
                lo, hi = stack.pop()
                out.append((lo, hi))
                if hi - lo > 1:
                    mid = (lo + hi) // 2
                    stack += [(lo, mid), (mid, hi)]
            return out

        ids = []
        for ax, r in enumerate(radices):
            tab = np.full((r, r + 1), -1, np.int64)
            for i, (lo, hi) in enumerate(dyadic(r)):
                tab[lo, hi] = i
            ids.append(tab)

        def col_tables(ax):
            vals = self.axes[ax]
            ivs = dyadic(radices[ax])
            return (np.array([vals[lo:hi].min() for lo, hi in ivs]),
                    np.array([vals[lo:hi].max() for lo, hi in ivs]))

        def vec_tables(table, ax):  # (W, R) -> (D, W) min/max
            ivs = dyadic(radices[ax])
            return (np.stack([table[:, lo:hi].min(axis=1) for lo, hi in ivs]),
                    np.stack([table[:, lo:hi].max(axis=1) for lo, hi in ivs]))

        def pair_tables(table, ax_a, ax_b):  # (W, A, B) -> (Da, Db, W)
            iv_a = dyadic(radices[ax_a])
            iv_b = dyadic(radices[ax_b])
            red_lo = np.stack([table[:, lo:hi].min(axis=1)
                               for lo, hi in iv_a])   # (Da, W, B)
            red_hi = np.stack([table[:, lo:hi].max(axis=1)
                               for lo, hi in iv_a])
            lo_t = np.stack([red_lo[:, :, lo:hi].min(axis=-1)
                             for lo, hi in iv_b], axis=1)  # (Da, Db, W)
            hi_t = np.stack([red_hi[:, :, lo:hi].max(axis=-1)
                             for lo, hi in iv_b], axis=1)
            return lo_t, hi_t

        self._eager = {
            "ids": ids,
            "cols": [col_tables(ax) for ax in range(5)],
            "fm": pair_tables(self.f_m, 0, 3),
            "fn": vec_tables(self.f_n, 2),
            "fk": pair_tables(self.f_k, 1, 4),
        }

    @staticmethod
    def from_workload(fspace: FactorizedSpace, wl,
                      c: DeviceConstants = CONSTANTS,
                      dtype=np.float64) -> "SlabBoundEvaluator":
        """Build the evaluator for one workload's GEMM list over `fspace`.

        Prefer `cached_bound_evaluator` in long-lived processes — the
        construction precomputes the per-axis interval tables, which is
        worth keeping resident across queries.
        """
        from .photonic_model import sram_mb_for_workload
        sram_mb = sram_mb_for_workload(wl.max_act_bytes, c)
        return SlabBoundEvaluator(fspace.axes, wl.gemm_array, wl.elec_ops,
                                  wl.weight_bytes, wl.act_io_bytes, sram_mb,
                                  c, dtype)

    def _col(self, ax, rng):
        ext = self._col_ext.get((ax, rng))
        if ext is None:
            seg = self.axes[ax][rng[0]:rng[1]]
            ext = (int(seg.min()), int(seg.max()))
            self._col_ext[(ax, rng)] = ext
        return ext

    def _pair(self, cache, table, r0, r1):
        ext = cache.get((r0, r1))
        if ext is None:
            blk = table[:, r0[0]:r0[1], r1[0]:r1[1]].reshape(len(table), -1)
            ext = (blk.min(axis=1), blk.max(axis=1))
            cache[(r0, r1)] = ext
        return ext

    def _vec(self, cache, table, rng):
        ext = cache.get(rng)
        if ext is None:
            seg = table[:, rng[0]:rng[1]]
            ext = (seg.min(axis=1), seg.max(axis=1))
            cache[rng] = ext
        return ext

    def lower_bounds_batch(self, ranges_batch) -> Dict[str, np.ndarray]:
        """{metric: (B,) lower-bound array} over a batch of slabs, every
        REPORT_METRICS key. One vectorized arithmetic pass: per-slab
        extremum rows are gathered from the interval caches into (B, W) /
        (B,) arrays, then the combine replays `evaluate_space`'s op chain
        on them (see the class docstring for why that is sound)."""
        c = self.c
        d = self.dtype
        if self._eager is None:
            self._build_eager()
        arr = np.asarray(ranges_batch, np.int64)
        lo, hi = arr[:, :, 0], arr[:, :, 1]
        ids = np.stack([self._eager["ids"][ax][lo[:, ax], hi[:, ax]]
                        for ax in range(5)])
        if ids.min(initial=0) >= 0:
            # All-dyadic batch: pure vectorized lookups, no per-slab
            # python at all (the branch-and-bound hot path).
            cols_lo = np.stack(
                [self._eager["cols"][ax][0][ids[ax]]
                 for ax in range(5)]).astype(d)
            cols_hi = np.stack(
                [self._eager["cols"][ax][1][ids[ax]]
                 for ax in range(5)]).astype(d)
            fm = self._eager["fm"]
            fk = self._eager["fk"]
            fn = self._eager["fn"]
            f_ext = [(fm[s][ids[0], ids[3]], fn[s][ids[2]],
                      fk[s][ids[1], ids[4]]) for s in (0, 1)]
        else:
            col_ext = [[], [], [], [], []]
            m_ext, n_ext, k_ext = [], [], []
            for ranges in ranges_batch:
                rt, rc, rv, rh, rl = (tuple(r) for r in ranges)
                for ax, rng in enumerate((rt, rc, rv, rh, rl)):
                    col_ext[ax].append(self._col(ax, rng))
                m_ext.append(self._pair(self._fm_ext, self.f_m, rt, rh))
                n_ext.append(self._vec(self._fn_ext, self.f_n, rv))
                k_ext.append(self._pair(self._fk_ext, self.f_k, rc, rl))
            col_arr = np.asarray(col_ext, np.int64)
            cols_lo = col_arr[:, :, 0].astype(d)
            cols_hi = col_arr[:, :, 1].astype(d)
            f_m_ext = np.asarray(m_ext)
            f_n_ext = np.asarray(n_ext)
            f_k_ext = np.asarray(k_ext)
            f_ext = [(f_m_ext[:, s], f_n_ext[:, s], f_k_ext[:, s])
                     for s in (0, 1)]

        def cycles(side):
            # ((f_m*1.0) * f_n * f_k) * count — the combine's product chain
            # on the (B, W) factor extrema.
            fm_x, fn_x, fk_x = f_ext[side]
            return (fm_x.astype(d) * fn_x.astype(d) * fk_x.astype(d)
                    * self.count)

        cyc_lo = cycles(0)
        total_lo = np.sum(cyc_lo, axis=-1)
        t_phot_lo = total_lo / c.f_clk_hz
        latency_lo = np.maximum(t_phot_lo, self.t_mem) + self.t_elec

        n_t, n_c, n_v, n_h, n_l = cols_lo  # meshgrid order (t, c, v, h, l)
        area_lo, power_lo = eval_hw(n_t, n_c, n_h, n_v, n_l, self.sram_mb,
                                    c)
        lanes_lo = (n_t * n_h + n_v) * n_c * n_l
        sram_lo = np.sum(cyc_lo * lanes_lo[..., None], axis=-1) \
            * c.act_bits / 8.0
        energy_lo = (power_lo * latency_lo + self.dram_j
                     + c.e_sram_per_byte * sram_lo)

        # util is minimized at the *largest* cycle count and peak-MAC
        # product, so its lower bound takes the opposite extrema.
        total_hi = np.sum(cycles(1), axis=-1)
        t_hi, c_hi, v_hi, h_hi, l_hi = cols_hi
        peak_hi = t_hi * h_hi * v_hi * c_hi * l_hi
        util_lo = self.macs / np.maximum(total_hi * peak_hi, 1.0)

        return {"area": area_lo, "power": power_lo, "energy": energy_lo,
                "latency": latency_lo, "util": util_lo,
                "edp": energy_lo * latency_lo}

    def lower_bounds(self, ranges) -> Dict[str, float]:
        """{metric: lower bound} over one slab — the scalar form of
        `lower_bounds_batch` (same code path, so batched pruning decisions
        and the property-tested scalar oracle cannot diverge)."""
        out = self.lower_bounds_batch([tuple(tuple(r) for r in ranges)])
        return {k: float(v[0]) for k, v in out.items()}


@functools.lru_cache(maxsize=32)
def cached_bound_evaluator(fspace: FactorizedSpace, wl, c) -> \
        "SlabBoundEvaluator":
    """Process-resident `SlabBoundEvaluator.from_workload` (float64 form).

    Every argument is a frozen (hashable) dataclass, so repeat queries
    against the same (space, workload, constants) — any constraint-scenario
    sweep in one process — reuse the eager dyadic-interval tables instead
    of rebuilding them per call. Bounded LRU keeps a process that rotates
    through many workloads from accumulating tables without limit."""
    return SlabBoundEvaluator.from_workload(fspace, wl, c)


# ---------------------------------------------------------------------------
# Slab ledger: the branch-and-bound run's pruning decisions, kept around
# ---------------------------------------------------------------------------
#
# A bound-guided search partitions the product space into slabs it *pruned*
# (their interval lower bounds proved no winner / frontier member can live
# there) and slabs it *evaluated*. The drivers normally discard that
# partition once the counters are summed; retaining it — together with the
# pruned slabs' stored lower bounds — is what makes a later
# *constraint-delta* query incremental: a new constraint box re-prices the
# pruned slabs against their stored bounds (one vectorized compare) and only
# the slabs whose bounds straddle the new box are ever descended again
# (repro_torch.serve.SearchService is the consumer).

@dataclasses.dataclass
class SlabLedger:
    """Serializable record of one bound-guided search's slab partition.

    `pruned` holds the (P, 5, 2) digit ranges of every slab discarded by a
    bound (constraint, incumbent-EDP or frontier-dominance), with the
    admissible float64 lower bounds it was priced at in `bounds`
    ({metric: (P,)}, every `core.search.REPORT_METRICS` key). `evaluated`
    holds the (E, 5, 2) ranges of every leaf slab whose points reached an
    engine. Together they tile the space exactly: `accounted() ==
    prod(radices)` (asserted at capture time).

    Soundness for re-pricing: the stored bounds are lower bounds for every
    point of the slab, so a slab with ``bounds[m] >= new_limit`` stays dead
    under any constraint box whose `m`-limit is at or below `new_limit`,
    and a slab with ``bounds["edp"] > inc`` cannot beat a known-feasible
    incumbent EDP `inc` — the exact arguments the live search makes,
    replayed against persisted prices.
    """

    axes: Tuple[Tuple[int, ...], ...]      # identity of the priced space
    pruned: np.ndarray                     # (P, 5, 2) int64 digit ranges
    bounds: Dict[str, np.ndarray]          # {metric: (P,) float64}
    evaluated: np.ndarray                  # (E, 5, 2) int64 digit ranges

    def accounted(self) -> int:
        """Total points covered by the pruned + evaluated slabs."""
        total = 0
        for arr in (self.pruned, self.evaluated):
            if len(arr):
                total += int(np.prod(arr[:, :, 1] - arr[:, :, 0],
                                     axis=1).sum())
        return total

    def pruned_sizes(self) -> np.ndarray:
        """(P,) point counts of the pruned slabs (re-pricing bookkeeping)."""
        if not len(self.pruned):
            return np.zeros(0, np.int64)
        return np.prod(self.pruned[:, :, 1] - self.pruned[:, :, 0], axis=1)

    def evaluated_indices(self) -> np.ndarray:
        """Sorted flat indices of every point the search evaluated."""
        radices = tuple(len(a) for a in self.axes)
        return slab_indices_batch(radices, list(self.evaluated))

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Flat {name: ndarray} tree (np.savez / checkpoint-layer ready)."""
        out = {"axes": np.asarray(
                   [list(a) + [0] * (max(map(len, self.axes)) - len(a))
                    for a in self.axes], np.int64),
               "axis_lens": np.asarray([len(a) for a in self.axes],
                                       np.int64),
               "pruned": np.asarray(self.pruned, np.int64).reshape(-1, 5, 2),
               "evaluated": np.asarray(self.evaluated,
                                       np.int64).reshape(-1, 5, 2)}
        for k, v in self.bounds.items():
            out[f"lb_{k}"] = np.asarray(v, np.float64)
        return out

    @staticmethod
    def from_arrays(tree: Mapping) -> "SlabLedger":
        """Inverse of `to_arrays` (exact round-trip)."""
        lens = np.asarray(tree["axis_lens"], np.int64)
        axes = tuple(tuple(int(v) for v in row[:n])
                     for row, n in zip(np.asarray(tree["axes"]), lens))
        bounds = {k[3:]: np.asarray(v, np.float64)
                  for k, v in tree.items() if k.startswith("lb_")}
        return SlabLedger(
            axes=axes,
            pruned=np.asarray(tree["pruned"], np.int64).reshape(-1, 5, 2),
            bounds=bounds,
            evaluated=np.asarray(tree["evaluated"],
                                 np.int64).reshape(-1, 5, 2))

    def nbytes(self) -> int:
        """Serialized byte size of this ledger — the exact `save()` npz
        round-trip, which is the unit `repro_torch.serve.SearchService`'s
        `max_ledger_bytes=` budget accounts base entries in."""
        import io
        buf = io.BytesIO()
        np.savez_compressed(buf, **self.to_arrays())
        return buf.getbuffer().nbytes

    def save(self, path: str) -> None:
        """Persist as a compressed .npz archive."""
        np.savez_compressed(path, **self.to_arrays())

    @staticmethod
    def load(path: str) -> "SlabLedger":
        """Load a ledger persisted by `save`."""
        with np.load(path) as z:
            return SlabLedger.from_arrays({k: z[k] for k in z.files})


class LedgerRecorder:
    """Collects a bound-guided run's pruning decisions into a `SlabLedger`.

    The BnB drivers call `prune(ranges, lbs)` for every batch of slabs a
    bound discards and `evaluate(ranges)` for every batch an engine
    evaluates; `build()` concatenates the batches and checks that the two
    sets tile the space exactly (a driver bug that dropped or
    double-counted a slab would make every later delta query silently
    wrong, so the invariant is enforced, not assumed).
    """

    METRIC_KEYS = ("area", "power", "energy", "latency", "util", "edp")

    def __init__(self):
        self._pruned: list = []
        self._lbs: list = []
        self._eval: list = []

    def prune(self, ranges: np.ndarray, lbs: Mapping) -> None:
        """Record pruned slabs ((B, 5, 2) ranges + their bound arrays)."""
        if len(ranges):
            self._pruned.append(np.asarray(ranges, np.int64))
            self._lbs.append({k: np.asarray(lbs[k], np.float64)
                              for k in self.METRIC_KEYS})

    def evaluate(self, ranges: np.ndarray) -> None:
        """Record evaluated leaf slabs ((B, 5, 2) ranges)."""
        if len(ranges):
            self._eval.append(np.asarray(ranges, np.int64))

    def build(self, fspace: FactorizedSpace) -> SlabLedger:
        """Assemble the ledger and verify it tiles `fspace` exactly."""
        pruned = (np.concatenate(self._pruned) if self._pruned
                  else np.zeros((0, 5, 2), np.int64))
        bounds = {k: (np.concatenate([d[k] for d in self._lbs])
                      if self._lbs else np.zeros(0))
                  for k in self.METRIC_KEYS}
        evaluated = (np.concatenate(self._eval) if self._eval
                     else np.zeros((0, 5, 2), np.int64))
        ledger = SlabLedger(axes=fspace.axes, pruned=pruned, bounds=bounds,
                            evaluated=evaluated)
        if ledger.accounted() != fspace.size:
            raise AssertionError(
                f"slab ledger accounts for {ledger.accounted()} of "
                f"{fspace.size} points — a driver dropped or double-"
                f"counted a slab")
        return ledger
