"""The port's two frontier kernels, held against the Pallas kernels they
replace.

`dse_pareto_padded` and `dse_pareto_decoded` are given CPU tensors (so each
runs its plain PyTorch version) and the reference Pallas kernel runs in
interpret mode on the same numpy inputs, made from a seed. The reference is
compiled with XLA's algebraic simplifier off and LLVM at -O0 (`STRICT`, as in
`test_torch_dse_kernels.py`), so its float32 arithmetic is the kernel
source's. Tolerance: exact — the raw (PARETO_ROWS * W, n_blocks) arrays
(front count, feasible count, emitted indices) must be equal bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.paper_workloads import load
from repro.core.pareto import pareto_mask
from repro.core.performance_model import workload_statics as ref_statics
from repro.core.photonic_model import CONSTANTS as REF_C
from repro.kernels import dse_eval as rk
from repro_torch.core.performance_model import workload_statics
from repro_torch.interop import from_reference
from repro_torch.kernels import dse_eval as pk

STRICT = {"xla_disable_hlo_passes": "algsimp",
          "xla_backend_optimization_level": 0}
C = from_reference(REF_C)
D3 = ("area", "power", "edp")
D5 = ("area", "power", "energy", "latency", "edp")
PAPER_BOX = [60.0, 15.0, 0.1, 5e-3]
OPEN_BOX = [1e9, 1e9, 1e9, 1e9]


def _pallas(fn, *args, **static):
    """The reference kernel in interpret mode, compiled with STRICT."""
    f = functools.partial(fn, interpret=True, **static)
    args = [jnp.asarray(a) for a in args]
    return np.asarray(jax.jit(f).lower(*args).compile(STRICT)(*args))


def _statics(names):
    ref = tuple(ref_statics(load(n), REF_C) for n in names)
    port = tuple(workload_statics(from_reference(load(n)), C)
                 for n in names)
    assert ref == port
    return ref, port


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cons(w, box=PAPER_BOX):
    return np.tile(np.asarray([box], np.float32), (w, 1))


def _carry(port_wl, objectives, seed):
    """(W * CARRY_FRONT, d) carried points: per workload, the float32
    objective points of the front of 3000 seeded configs under the paper
    box (real, strong design points, so they dominate part of every
    block), at most CARRY_FRONT of them, +inf padded."""
    d = len(objectives)
    carry = np.full((len(port_wl) * pk.CARRY_FRONT, d), np.inf, np.float32)
    cfg = np.random.default_rng(seed).integers(1, 13, size=(5, 3000)) \
        .astype(np.float32)
    for w, (g, s) in enumerate(port_wl):
        m = pk.dse_eval_padded_plain(_t(cfg), gemms=g, wl_scalars=s,
                                     constants=C).numpy()
        ok = np.all(m < np.asarray(PAPER_BOX, np.float32)[:, None], axis=0)
        vals = {"area": m[0], "power": m[1], "energy": m[2],
                "latency": m[3], "edp": m[2] * m[3]}
        pts = np.stack([vals[k][ok] for k in objectives], axis=1)
        pts = pts[pareto_mask(pts)][:pk.CARRY_FRONT]
        carry[w * pk.CARRY_FRONT:w * pk.CARRY_FRONT + len(pts)] = pts
    return carry


def _padded_case(case):
    """(names, cfg, mask, cons, objectives, carry or None) of one case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    names = ["deit-t", "bert-b"]
    g = 5000 if case == "partial_d3" else 4096
    cfg = rng.integers(1, 13, size=(5, g)).astype(np.float32)
    mask = np.ones((1, g), np.float32)
    objectives = D5 if case.endswith("d5") else D3
    carry = None
    if case == "masked_d5":
        mask[0, rng.random(g) < 0.3] = 0.0
    elif case.startswith("carry"):
        carry = _carry(_statics(names)[1], objectives, 5)
    elif case == "overflow":
        # A whole block of one feasible config: 2048 exact ties, all on the
        # front, far past MAX_FRONT; the next block is partial.
        names = ["deit-t"]
        cfg = np.concatenate(
            [np.tile(np.asarray([[1], [2], [12], [12], [11]], np.float32),
                     (1, pk.BLOCK)), cfg[:, :500]], axis=1)
        mask = np.ones((1, cfg.shape[1]), np.float32)
    return names, cfg, mask, _cons(len(names)), objectives, carry


PADDED_CASES = ["partial_d3", "masked_d5", "carry_d3", "carry_d5",
                "overflow"]


@pytest.mark.parametrize("case", PADDED_CASES)
def test_dse_pareto_padded_matches_pallas(case):
    names, cfg, mask, cons, objectives, carry = _padded_case(case)
    ref_wl, port_wl = _statics(names)
    has_carry = carry is not None
    if carry is None:
        carry = np.full((len(names) * pk.CARRY_FRONT, len(objectives)),
                        np.inf, np.float32)
    ref = _pallas(rk.dse_pareto_padded, cfg, mask, cons, carry,
                  workloads=ref_wl, objectives=objectives,
                  has_carry=has_carry, constants=REF_C)
    got = pk.dse_pareto_padded(_t(cfg), _t(mask), _t(cons), _t(carry),
                               workloads=port_wl, objectives=objectives,
                               has_carry=has_carry, constants=C).numpy()
    assert got.shape == (pk.PARETO_ROWS * len(names),
                         -(-cfg.shape[1] // pk.BLOCK))
    assert np.array_equal(got, ref)
    if case == "overflow":
        assert got[0, 0] == pk.BLOCK                  # true count, > 128
        assert np.array_equal(got[pk.PARETO_HEADER:, 0],
                              np.arange(pk.MAX_FRONT, dtype=np.float32))
    if has_carry:
        # The carried points really pruned: fewer front lanes than without.
        free = pk.dse_pareto_padded(_t(cfg), _t(mask), _t(cons), _t(carry),
                                    workloads=port_wl, objectives=objectives,
                                    has_carry=False, constants=C).numpy()
        rows0 = slice(0, None, pk.PARETO_ROWS)
        assert got[rows0].sum() < free[rows0].sum()


def test_obj0_tie_keeps_a_dominated_earlier_lane():
    # Lanes 0 and 1 are (n_h, n_v) swaps: area and power tie exactly and
    # lane 1 has the lower EDP, so it dominates lane 0. The reference
    # orders the block by a stable sort on objective 0 and lets a row
    # dominate only the rows after it, so the tied pair is skipped and
    # lane 0 survives as a candidate; a true-dominance kernel would drop
    # it. The port must keep it too.
    cfg = np.asarray([[1, 1, 4, 12, 2], [1, 1, 12, 4, 2]], np.float32).T
    mask = np.ones((1, 2), np.float32)
    cons = _cons(1, OPEN_BOX)
    ref_wl, port_wl = _statics(["deit-t"])
    carry = np.full((pk.CARRY_FRONT, 3), np.inf, np.float32)
    m = pk.dse_eval_padded_plain(_t(cfg), gemms=port_wl[0][0],
                                 wl_scalars=port_wl[0][1],
                                 constants=C).numpy()
    pts = np.stack([m[0], m[1], m[2] * m[3]], axis=1)
    assert pts[0, 0] == pts[1, 0] and pts[0, 1] == pts[1, 1]
    assert pts[1, 2] < pts[0, 2]
    assert pareto_mask(pts).tolist() == [False, True]
    ref = _pallas(rk.dse_pareto_padded, cfg, mask, cons, carry,
                  workloads=ref_wl, objectives=D3, has_carry=False,
                  constants=REF_C)
    got = pk.dse_pareto_padded(_t(cfg), _t(mask), _t(cons), _t(carry),
                               workloads=port_wl, objectives=D3,
                               has_carry=False, constants=C).numpy()
    assert np.array_equal(got, ref)
    assert got[0, 0] == 2 and got[1, 0] == 2
    assert got[2:4, 0].tolist() == [0.0, 1.0]


# An uneven product space of 5 * 4 * 6 * 7 * 8 = 6720 points: four decoded
# blocks of BLOCK lanes, the last partial.
AXES = ((1, 2, 3, 6, 12), (1, 2, 4, 8), (2, 3, 4, 6, 8, 12),
        (1, 2, 3, 4, 6, 9, 12), (1, 2, 3, 4, 6, 8, 10, 12))
SIZE = int(np.prod([len(a) for a in AXES]))
SLAB = ((1, 5), (0, 3), (1, 6), (2, 7), (0, 5))


def _axes_operand():
    arr = np.ones((5, max(len(a) for a in AXES)), np.float32)
    for i, a in enumerate(AXES):
        arr[i, :len(a)] = a
    return arr


def _meta(start, end, slab=None):
    ranges = slab or tuple((0, len(a)) for a in AXES)
    return np.asarray([start, end] + [v for r in ranges for v in r],
                      np.int32)


# case -> (meta row, extra all-invalid blocks, objectives, carried)
DECODED_CASES = {
    "full_d3": (_meta(0, SIZE), 0, D3, False),
    "slab_carry_d5": (_meta(0, SIZE, SLAB), 0, D5, True),
    "offset_dead_tail": (_meta(1000, 5000), 1, D3, True),
}


@pytest.mark.parametrize("case", sorted(DECODED_CASES))
def test_dse_pareto_decoded_matches_pallas(case):
    meta, extra, objectives, has_carry = DECODED_CASES[case]
    n_blocks = -(-int(meta[1] - meta[0]) // pk.BLOCK) + extra
    names = ["deit-s", "bert-l"]
    ref_wl, port_wl = _statics(names)
    cons = _cons(2)
    carry = (_carry(port_wl, objectives, 9) if has_carry else
             np.full((2 * pk.CARRY_FRONT, len(objectives)), np.inf,
                     np.float32))
    radices = tuple(len(a) for a in AXES)
    axes = _axes_operand()
    ref = _pallas(rk.dse_pareto_decoded, axes, meta[None, :], cons, carry,
                  radices=radices, n_blocks=n_blocks, workloads=ref_wl,
                  objectives=objectives, has_carry=has_carry,
                  constants=REF_C)
    got = pk.dse_pareto_decoded(
        _t(axes), _t(meta), _t(cons), _t(carry), radices=radices,
        n_blocks=n_blocks, workloads=port_wl, objectives=objectives,
        has_carry=has_carry, constants=C).numpy()
    assert got.shape == (pk.PARETO_ROWS * 2, n_blocks)
    assert np.array_equal(got, ref)
    assert got[1::pk.PARETO_ROWS].sum() > 0        # something was feasible


def test_frontier_wrappers_refuse_util_and_bad_carry():
    _, port_wl = _statics(["deit-t"])
    cfg = _t(np.ones((5, 10), np.float32))
    mask = _t(np.ones((1, 10), np.float32))
    cons = _t(_cons(1))
    with pytest.raises(ValueError, match="util"):
        pk.dse_pareto_padded(cfg, mask, cons,
                             _t(np.full((128, 2), np.inf, np.float32)),
                             workloads=port_wl, objectives=("area", "util"),
                             constants=C)
    pk.reset_launch_counts()
    pk.dse_pareto_padded(cfg, mask, cons,
                         _t(np.full((128, 3), np.inf, np.float32)),
                         workloads=port_wl, objectives=D3, constants=C)
    assert set(pk.LAUNCHES.values()) == {0}   # CPU tensors launch nothing
    assert (pk.MAX_FRONT, pk.PARETO_HEADER, pk.PARETO_ROWS,
            pk.CARRY_FRONT, pk.DOM_CHUNK) == (
        rk.MAX_FRONT, rk.PARETO_HEADER, rk.PARETO_ROWS, rk.CARRY_FRONT,
        rk.DOM_CHUNK)


# ------------------------------------- the frontier kernels' design ---
# numpy emulations of csrc/dse_eval.cu's division-free pricing and of the
# compact-then-sort frontier stage, held against the reference.

def _radix_magic(r):
    """(mul, shift) of make_radix: l = ceil(log2 r), mul = ceil(2^(31 + l)
    / r), shift = 31 + l."""
    l = (int(r) - 1).bit_length()
    return ((1 << (31 + l)) + int(r) - 1) // int(r), 31 + l


def _div_radix(n, r):
    """(n / r, n % r) of div_radix: one widening multiply and a shift."""
    mul, shift = _radix_magic(r)
    assert mul < 2 ** 32
    q = ((np.asarray(n, np.int64).astype(np.uint64) * np.uint64(mul))
         >> np.uint64(shift)).astype(np.int64)
    return q, np.asarray(n, np.int64) - q * int(r)


def _decode_magic(gidx, radices):
    """decode_lane's digits (t, c, v, h, lambda), division-free."""
    _, r_c, r_v, r_h, r_l = radices
    i, d_l = _div_radix(gidx, r_l)
    i, d_h = _div_radix(i, r_h)
    i, d_v = _div_radix(i, r_v)
    d_t, d_c = _div_radix(i, r_c)
    return d_t, d_c, d_v, d_h, d_l


def _reference_digits(gidx, radices):
    """The digits `repro`'s _decode_block uses (decode_digits, int32)."""
    from repro.core.factorized import decode_digits
    return [np.asarray(x) for x in decode_digits(
        jnp.asarray(gidx, jnp.int32), radices, xp=jnp)]


DECODE_SPANS = {
    **{case: (tuple(len(a) for a in AXES), int(meta[0]),
              (-(-int(meta[1] - meta[0]) // pk.BLOCK) + extra) * pk.BLOCK)
       for case, (meta, extra, _, _) in DECODED_CASES.items()},
    "offset_24x5": ((24,) * 5, 24 ** 5 - 123_457, 200_000),
    "full_24x5": ((24,) * 5, 0, 3888 * pk.BLOCK),
}


@pytest.mark.parametrize("span", sorted(DECODE_SPANS))
def test_division_free_decode_equals_the_reference_digits(span):
    radices, start, width = DECODE_SPANS[span]
    gidx = start + np.arange(width, dtype=np.int64)
    got = _decode_magic(gidx, radices)
    want = _reference_digits(gidx, radices)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_division_free_quotient_is_exact_below_2_31():
    rng = np.random.default_rng(17)
    n = np.concatenate([rng.integers(0, 2 ** 31, 20000),
                        [0, 1, 2 ** 31 - 1, 2 ** 24, 2 ** 24 - 1]])
    for r in list(range(1, 65)) + [97, 576, 1000, 4096, 65535, 2 ** 20 + 7,
                                   2 ** 30, 2 ** 31 - 1]:
        q, rem = _div_radix(n, r)
        assert np.array_equal(q, n // r) and np.array_equal(rem, n % r)


def _ceil_div_inv(a, b):
    """ceil_div: inv = floor((2^32 - 1) / b) once per divisor, q =
    umulhi(a, inv) (floor(a / b) or one less), one correction step.
    Returns (ceil, the first estimate q)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    inv = (2 ** 32 - 1) // b
    est = (a * inv) >> 32          # < 2^63 for a < 2^31
    q = np.where(a - est * b >= b, est + 1, est)
    return q + ((a - q * b) > 0), est


def _paper_gemm_dims():
    from repro.core.paper_workloads import PAPER_WORKLOADS
    dims = set()
    for name in PAPER_WORKLOADS:
        gemms, _ = ref_statics(load(name), REF_C)
        for m, k, n, _ in gemms:
            dims.update((int(m), int(k), int(n)))
    return np.asarray(sorted(dims), np.int64)


def test_exact_ceil_division_over_the_24x5_divisors():
    # d_m = t * h, d_n = v, d_k = c * lambda: every divisor the 24^5
    # space allows is a product of two axis values in 1..24.
    divisors = np.asarray(sorted({x * y for x in range(1, 25)
                                  for y in range(1, 25)}), np.int64)
    dims = _paper_gemm_dims()
    assert dims.max() < 2 ** 24
    sweep = np.random.default_rng(23).integers(0, 2 ** 24, 4096)
    edges = np.asarray([0, 1, 2, 2 ** 23, 2 ** 24 - 1, 2 ** 24, 2 ** 24 + 1,
                        2 ** 30, 2 ** 31 - 1], np.int64)
    a = np.concatenate([dims, sweep, edges])[:, None]
    b = divisors[None, :]
    got, est = _ceil_div_inv(a, b)
    assert np.array_equal(got, -(-a // b))
    # one correction step suffices: the estimate is a // b or one less
    assert set(np.unique(a // b - est)) <= {0, 1}


def _sort_key(x):
    """sort_key: monotone uint32 key of float32 values."""
    u = np.asarray(x, np.float32).view(np.uint32).copy()
    u[(u & 0x7fffffff) == 0] = 0
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return np.where((u & 0x7fffffff) > 0x7f800000, np.uint32(0xffffffff),
                    key)


def _compact_front(objs, ok, carry_pts=None, batch=64):
    """(n,) front mask of one block by the kernels' compacted design: only
    the feasible lanes become rows (every lane, infeasible ones at +inf,
    when some feasible objective 0 is not finite), sorted by (objective-0
    key, lane); columns in batches of `batch`, each compared (unless its
    DOM_CHUNK tile starts at a non-finite objective 0) with the earlier
    rows of its batch and the listed rows of earlier batches — the rows no
    earlier row dominated, less those equal to their sorted predecessor;
    then the carried points; the flags scatter back by lane."""
    ok = np.asarray(ok, bool)
    o = [np.where(ok, np.asarray(x, np.float32), np.float32(np.inf))
         for x in objs]
    lanes = np.arange(ok.shape[0])
    all_lanes = bool((ok & ~np.isfinite(o[0])).any())
    rows = lanes if all_lanes else lanes[ok]
    keys = ((_sort_key(o[0][rows]).astype(np.uint64) << np.uint64(32))
            | rows.astype(np.uint64))
    rows = rows[np.argsort(keys)]
    so = np.stack([x[rows] for x in o])
    front = np.zeros(ok.shape[0], bool)
    listed = []
    for j0 in range(0, len(rows), batch):
        new = []
        for j in range(j0, min(j0 + batch, len(rows))):
            lane = rows[j]
            if not ok[lane]:
                continue
            x = so[:, j:j + 1]
            dominated = False
            if np.isfinite(so[0, j & ~(pk.DOM_CHUNK - 1)]):
                cand = so[:, listed + list(range(j0, j))]
                dominated = bool(np.any(np.all(cand <= x, axis=0)
                                        & np.any(cand < x, axis=0)))
            keep = not dominated
            if keep and carry_pts is not None:
                c = np.asarray(carry_pts, np.float32).T
                keep = not np.any(np.all(c <= x, axis=0)
                                  & np.any(c < x, axis=0))
            front[lane] = keep
            if not dominated and not (j > 0 and np.array_equal(
                    so[:, j], so[:, j - 1])):
                new.append(j)
        listed += new
    return front


def _reference_front(objs, ok, carry_pts=None):
    """`repro`'s _block_front, then its carried-front prune."""
    o = tuple(jnp.asarray(np.asarray(x, np.float32)) for x in objs)
    okj = jnp.asarray(ok)
    front = np.array(rk._block_front(o, okj))
    if carry_pts is not None:
        front &= ~np.asarray(rk._carry_dominated(
            jnp.asarray(carry_pts),
            tuple(jnp.where(okj, x, jnp.inf) for x in o)))
    return front


def _blocks(cols, valid, port_wl, cons, objectives):
    """Per workload, per BLOCK-lane block: (objectives, feasible) from the
    port's plain cost model, the kernels' float32 metrics."""
    k, per_wl = pk._statics(port_wl, C)
    out = []
    for w, (wl, gm) in enumerate(per_wl):
        area, power = pk._config_metrics_hw(k, wl, *cols)
        energy, latency = pk._config_metrics_wl(k, wl, gm, power, *cols)
        ok = (valid & (area < cons[w, 0]) & (power < cons[w, 1])
              & (energy < cons[w, 2]) & (latency < cons[w, 3])).numpy()
        vals = {"area": area, "power": power, "energy": energy,
                "latency": latency, "edp": energy * latency}
        objs = [vals[m].numpy() for m in objectives]
        for b in range(0, ok.shape[0], pk.BLOCK):
            out.append((w, [x[b:b + pk.BLOCK] for x in objs],
                        ok[b:b + pk.BLOCK]))
    return out


def _padded_blocks(names, cfg, mask, cons, objectives):
    _, port_wl = _statics(names)
    cols, m = pk._pad_cols(_t(cfg), _t(mask))
    return _blocks(tuple(cols[i] for i in range(5)), m[0] > 0.0, port_wl,
                   _t(cons), objectives)


FRONT_CASES = ["decoded:" + c for c in sorted(DECODED_CASES)] + [
    "padded:overflow", "padded:carry_d3", "padded:obj0_tie"]


@pytest.mark.parametrize("case", FRONT_CASES)
def test_compact_then_sort_front_equals_the_reference(case):
    kind, name = case.split(":")
    carry = None
    if kind == "decoded":
        meta, extra, objectives, has_carry = DECODED_CASES[name]
        n_blocks = -(-int(meta[1] - meta[0]) // pk.BLOCK) + extra
        names = ["deit-s", "bert-l"]
        _, port_wl = _statics(names)
        radices = tuple(len(a) for a in AXES)
        cols, _, valid = pk._decode_block_plain(
            radices, _t(_axes_operand()), _t(meta), n_blocks, pk.BLOCK)
        blocks = _blocks(cols, valid, port_wl, _t(_cons(2)), objectives)
        if has_carry:
            carry = _carry(port_wl, objectives, 9)
    elif name == "obj0_tie":
        cfg = np.asarray([[1, 1, 4, 12, 2], [1, 1, 12, 4, 2]], np.float32).T
        blocks = _padded_blocks(["deit-t"], cfg, np.ones((1, 2), np.float32),
                                _cons(1, OPEN_BOX), D3)
    else:
        names, cfg, mask, cons, objectives, carry = _padded_case(name)
        blocks = _padded_blocks(names, cfg, mask, cons, objectives)
    n_front = 0
    for w, objs, ok in blocks:
        cw = (None if carry is None else
              carry[w * pk.CARRY_FRONT:(w + 1) * pk.CARRY_FRONT])
        got = _compact_front(objs, ok, cw)
        assert np.array_equal(got, _reference_front(objs, ok, cw))
        assert not (got & ~ok).any()
        n_front += int(got.sum())
    assert n_front > 0
    if name == "obj0_tie":
        assert n_front == 2      # the tied, dominated earlier lane stays
    if name == "overflow":
        assert n_front > pk.BLOCK    # the duplicate block's 2048, and more


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_front_handles_non_finite_feasible_objective_0(seed):
    """The fallback of the compacted design: a block with a feasible lane
    whose objective 0 is +inf sorts every lane (the tie with the +inf
    infeasible rows and the DOM_CHUNK skip then depend on them) and still
    equals the reference; without such a lane only feasible rows sort."""
    rng = np.random.default_rng(seed)
    n = pk.BLOCK
    ok = rng.random(n) < 0.4
    objs = [rng.integers(0, 6, n).astype(np.float32),   # ties, and whole
            rng.integers(0, 20, n).astype(np.float32),  # equal rows
            rng.integers(0, 4, n).astype(np.float32)]
    assert np.array_equal(_compact_front(objs, ok), _reference_front(objs, ok))
    odd = np.flatnonzero(ok)[rng.choice(int(ok.sum()), 30, replace=False)]
    objs[0][odd] = np.inf
    ok[:600] = False             # a DOM_CHUNK tile start among +inf rows
    assert (ok & ~np.isfinite(objs[0])).any()
    assert np.array_equal(_compact_front(objs, ok), _reference_front(objs, ok))
