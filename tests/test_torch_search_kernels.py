"""The min-EDP search kernels' design, emulated in numpy and held against
the plain versions and the Pallas kernels they replace.

`csrc/dse_eval.cu` splits each logical block of `dse_search_padded`
(BLOCK lanes) and `dse_search_decoded` (DECODE_BLOCK lanes) across a
cluster of SPLIT CTAs; every CTA prices its lanes (the decoded kernel
walks runs of RUN consecutive lanes, stepping the digits), reduces them to
a partial (smallest key (sort_key(EDP) << 32) | lane, feasible count), and
the cluster's leader combines the partials and applies the carry rule.
The CUDA code cannot run here, so `emulate_search` repeats that structure
with numpy float32 arithmetic in the kernel's order — the area/power
prefix from the terms above lambda, each workload's tail, then the
dataflow half of the area/power survivors — and must equal the port's
plain versions on every case and `repro`'s Pallas kernels (interpret
mode, compiled `STRICT`) where named below, exactly: `np.array_equal` on
the raw output arrays.
"""
import numpy as np
import pytest
import torch

from repro.kernels import dse_eval as rk
from repro_torch.core.factorized import decode_digits
from repro_torch.kernels import dse_eval as pk
from repro_torch.kernels import ops
from test_torch_dse_kernels import (AXES, C, DECODE_CASES, NAMES, REF_C,
                                    _axes_operand, _cfg, _n_blocks, _pallas,
                                    _statics, _t)

SPLIT = 8                          # CTAs (one cluster) per logical block
THREADS = 256                      # threads per CTA
RUN = pk.DECODE_BLOCK // SPLIT // THREADS  # consecutive decoded lanes a thread
NO_KEY = np.uint64(0xFF800000FFFFFFFF)     # (sort_key(+inf) << 32) | ~0
(A_MOD, A_DDOT, A_CORE, A_ADC, A_COMB0, A_COMB1, A_TILE, A_NET, A_CHIP,
 P_MOD, P_PD, P_ADC, P_ACC, P_CORE, P_COMB0, P_COMB1, P_LASER, P_TILE,
 P_NET, P_CHIP, F_CLK, SRAM_SCALE, E_SRAM) = range(pk.N_CONST)
f32 = np.float32


def sort_key(v):
    """The kernels' monotone uint32 key of float32 values."""
    u = np.ascontiguousarray(v, np.float32).view(np.uint32).copy()
    u[(u & 0x7FFFFFFF) == 0] = 0
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    key[(u & 0x7FFFFFFF) > 0x7F800000] = 0xFFFFFFFF
    return key


def upper_terms(k, t, c, h, v):
    """The area/power terms that do not depend on lambda (upper_terms)."""
    cores = t * c
    ddots = (cores * h) * v
    adc = (t * h) * v
    return dict(t=t, h=h, v=v, ch=cores * (h + v), tl=t * k[P_LASER],
                a=[ddots * k[A_DDOT], cores * k[A_CORE], adc * k[A_ADC],
                   t * k[A_TILE], (k[A_NET] * t) * t],
                q=[(ddots * f32(2.0)) * k[P_PD], adc * k[P_ADC],
                   ddots * k[P_ACC], cores * k[P_CORE], t * k[P_TILE],
                   (k[P_NET] * t) * t])


def hw_prefix_lane(k, u, l):
    """(a_pre, q_pre): the sums before the workload's SRAM term, in the
    reference's order of additions (hw_prefix_lane)."""
    mod = u["ch"] * l
    a = mod * k[A_MOD]
    a = a + u["a"][0]
    a = a + u["a"][1]
    a = a + u["a"][2]
    a = a + u["t"] * (k[A_COMB1] * l + k[A_COMB0])
    a = a + u["a"][3]
    a = a + u["a"][4]
    q = mod * k[P_MOD]
    for term in u["q"][:4]:
        q = q + term
    q = q + u["t"] * (k[P_COMB1] * l + k[P_COMB0])
    q = q + ((u["tl"] * l) * u["h"]) * u["v"]
    q = q + u["q"][4]
    q = q + u["q"][5]
    return a, q


def dataflow(k, wl, gemms, power, t, c, h, v, l):
    """(energy, latency) of the dataflow half (wl_shared, wl_tail)."""
    lanes = (((t * h) + v) * c) * l
    d_m = np.trunc(t * h).astype(np.int64)
    d_n = np.trunc(v).astype(np.int64)
    d_k = np.trunc(c * l).astype(np.int64)
    total = np.zeros_like(t)
    sram = np.zeros_like(t)
    for m, kk, n, cnt in gemms:
        cyc = ((f32((m + d_m - 1) // d_m) * f32((n + d_n - 1) // d_n))
               * f32((kk + d_k - 1) // d_k)) * f32(cnt)
        total = total + cyc
        sram = sram + cyc * lanes
    lat = np.fmax(total / k[F_CLK], f32(wl[2])) + f32(wl[3])
    energy = (power * lat + f32(wl[4])) + (sram * k[SRAM_SCALE]) * k[E_SRAM]
    return energy, lat


def emulate_search(cols, valid, lane, n_blocks, block, base, cons, carry,
                   workloads, decoded):
    """The search kernels' output, (3W, n_blocks), from lanes laid out as
    (n_blocks * block,) vectors: `cols` the five config columns (t, c, h,
    v, l), `valid` the span/slab/mask test, `lane` each lane's block-local
    index, `base` each block's first index."""
    k = [f32(x) for x in pk._folded_constants(C)]
    n_sub = block // SPLIT
    t, c, h, v, l = (np.asarray(x, np.float32) for x in cols)
    a_pre, q_pre = hw_prefix_lane(k, upper_terms(k, t, c, h, v), l)
    out = np.empty((pk.SEARCH_ROWS * len(workloads), n_blocks), np.float32)
    for w, (gemms, scalars) in enumerate(workloads):
        wl = pk._folded_workload(scalars, C)
        area = (a_pre + f32(wl[0])) + k[A_CHIP]
        power = (q_pre + f32(wl[1])) + k[P_CHIP]
        queued = valid & (area < cons[w, 0]) & (power < cons[w, 1])
        energy, lat = dataflow(k, wl, pk._gemm_ints(gemms), power, t, c, h,
                               v, l)
        ok = queued & (energy < cons[w, 2]) & (lat < cons[w, 3])
        key = np.where(ok, (sort_key(energy * lat).astype(np.uint64) << 32)
                       | lane.astype(np.uint64), NO_KEY)
        # each CTA's partial, then the leader's combine over the cluster
        part_key = key.reshape(n_blocks, SPLIT, n_sub).min(axis=2)
        part_nf = ok.reshape(n_blocks, SPLIT, n_sub).sum(axis=2)
        best_key, nf = part_key.min(axis=1), part_nf.sum(axis=1)
        hi = (best_key >> 32).astype(np.uint32)
        best = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi) \
            .astype(np.uint32).view(np.float32)
        at = (best_key & 0xFFFFFFFF).astype(np.int64)
        at = np.where(at == 0xFFFFFFFF, 0, at)
        idx = (f32(base + at) if decoded
               else f32(base) + at.astype(np.float32))
        carried = carry[w, 0] <= best
        out[3 * w] = np.where(carried, carry[w, 0], best)
        out[3 * w + 1] = np.where(carried, f32(pk.CARRY_IDX), idx)
        out[3 * w + 2] = nf.astype(np.float32)
    return out


def run_digits(radices, gidx0, n_lanes):
    """Digits of lanes gidx0, gidx0 + 1, ... as the decoded kernel's
    threads find them: a full decode at each run's first lane, then
    next_digits (lambda steps; a digit reaching its radix wraps and
    carries)."""
    gidx = gidx0 + np.arange(n_lanes, dtype=np.int64)
    start = gidx.reshape(-1, RUN)[:, 0]
    d = [np.repeat(x[:, None], RUN, axis=1).copy()
         for x in decode_digits(start, radices)]
    r_t, r_c, r_v, r_h, r_l = radices
    for r in range(1, RUN):
        dt, dc, dv, dh, dl = (x[:, r - 1].copy() for x in d)
        dl += 1
        wrap = dl == r_l
        dl[wrap] = 0
        dh = dh + wrap
        carry = dh == r_h
        dh[carry] = 0
        dv = dv + carry
        carry = dv == r_v
        dv[carry] = 0
        dc = dc + carry
        carry = dc == r_c
        dc[carry] = 0
        dt = dt + carry
        for x, y in zip(d, (dt, dc, dv, dh, dl)):
            x[:, r] = y
    return tuple(x.reshape(-1) for x in d)


def decoded_lanes(axes_arr, meta, radices, n_blocks):
    """(cols, valid, lane, base) of a decoded launch, digits by the run
    walk, in the (n_blocks * DECODE_BLOCK,) layout."""
    n = n_blocks * pk.DECODE_BLOCK
    gidx = int(meta[0]) + np.arange(n, dtype=np.int64)
    d_t, d_c, d_v, d_h, d_l = run_digits(radices, int(meta[0]), n)
    valid = gidx < meta[1]
    for ax, d in enumerate((d_t, d_c, d_v, d_h, d_l)):
        valid &= (d >= meta[2 + 2 * ax]) & (d < meta[3 + 2 * ax])
    top = axes_arr.shape[1] - 1
    pick = [axes_arr[row][np.clip(d, 0, top)]
            for row, d in ((0, d_t), (1, d_c), (3, d_h), (2, d_v), (4, d_l))]
    lane = np.tile(np.arange(pk.DECODE_BLOCK, dtype=np.int64), n_blocks)
    base = int(meta[0]) + np.arange(n_blocks, dtype=np.int64) \
        * pk.DECODE_BLOCK
    return pick, valid, lane, base


def emulate_decoded(axes_arr, meta, cons, carry, radices, n_blocks,
                    workloads):
    cols, valid, lane, base = decoded_lanes(axes_arr, meta, radices,
                                            n_blocks)
    return emulate_search(cols, valid, lane, n_blocks, pk.DECODE_BLOCK, base,
                          cons, carry, workloads, decoded=True)


def emulate_padded(cfg, mask, cons, carry, workloads):
    g = cfg.shape[1]
    n_blocks = -(-g // pk.BLOCK)
    pad = n_blocks * pk.BLOCK - g
    cols = np.pad(cfg, ((0, 0), (0, pad)), constant_values=1.0)
    valid = np.pad(mask[0], (0, pad)) > 0.0
    lane = np.tile(np.arange(pk.BLOCK, dtype=np.int64), n_blocks)
    base = np.arange(n_blocks, dtype=np.int64) * pk.BLOCK
    return emulate_search(tuple(cols), valid, lane, n_blocks, pk.BLOCK,
                          base, cons, carry, workloads, decoded=False)


def _workload_set(w):
    return (["deit-b"], ["deit-s", "bert-l"], NAMES)[(1, 2, 5).index(w)]


def _bounds(w):
    cons = np.tile(np.asarray([[60.0, 15.0, 0.1, 5e-3]], np.float32), (w, 1))
    return cons, np.full((w, 1), np.inf, np.float32)


# The Pallas kernel runs where it adds to test_torch_dse_kernels.py, which
# holds the plain versions to it on every case at W = 2 (decoded) and
# W = 3 (grid operand): one slab and the carried tie here, at W = 1 and 5.
PALLAS_DECODED = {("slab", 1), ("carry_tie", 5)}


@pytest.mark.parametrize("case", sorted(DECODE_CASES) + ["carry_tie"])
@pytest.mark.parametrize("w", [1, 2, 5])
def test_decoded_emulation_matches_plain_and_pallas(case, w):
    meta = DECODE_CASES.get(case, DECODE_CASES["full"])[0]
    n_blocks = _n_blocks(case if case in DECODE_CASES else "full",
                         pk.DECODE_BLOCK)
    ref_wl, port_wl = _statics(_workload_set(w))
    cons, carry = _bounds(w)
    radices = tuple(len(a) for a in AXES)
    axes = _axes_operand()

    def plain(carry):
        return pk.dse_search_decoded(
            _t(axes), _t(meta), _t(cons), _t(carry), radices=radices,
            n_blocks=n_blocks, workloads=port_wl, constants=C).numpy()

    emu = emulate_decoded(axes, meta, cons, carry, radices, n_blocks, port_wl)
    assert np.array_equal(emu, plain(carry))
    if case == "carry_tie":
        carry[:, 0] = emu[0::pk.SEARCH_ROWS, 0]  # block 0's best EDPs
        emu = emulate_decoded(axes, meta, cons, carry, radices, n_blocks,
                              port_wl)
        assert np.array_equal(emu, plain(carry))
        assert (emu[1::pk.SEARCH_ROWS, 0] == pk.CARRY_IDX).all()
    if (case, w) in PALLAS_DECODED:
        ref = _pallas(rk.dse_search_decoded, axes, meta[None, :], cons,
                      carry, radices=radices, n_blocks=n_blocks,
                      workloads=ref_wl, constants=REF_C)
        assert np.array_equal(emu, ref)


@pytest.mark.parametrize("w", [1, 2, 5])
def test_padded_emulation_matches_plain_and_pallas(w):
    rng = np.random.default_rng(40 + w)
    cfg = _cfg(rng, 5000)  # a partial last block
    mask = (rng.random((1, 5000)) > 0.2).astype(np.float32)
    ref_wl, port_wl = _statics(_workload_set(w))
    cons, carry = _bounds(w)
    emu = emulate_padded(cfg, mask, cons, carry, port_wl)
    got = pk.dse_search_padded(_t(cfg), _t(mask), _t(cons), _t(carry),
                               workloads=port_wl, constants=C).numpy()
    assert np.array_equal(emu, got)
    if w != 2:
        ref = _pallas(rk.dse_search_padded, cfg, mask, cons, carry,
                      workloads=ref_wl, constants=REF_C)
        assert np.array_equal(emu, ref)


def test_padded_tie_across_ctas_takes_the_lowest_lane():
    # One 256-lane pattern repeated over the block's eight CTAs: the best
    # EDP sits in every CTA, and the leader must keep CTA 0's lane.
    rng = np.random.default_rng(7)
    cfg = np.tile(_cfg(rng, pk.BLOCK // SPLIT), (1, SPLIT))
    mask = np.ones((1, pk.BLOCK), np.float32)
    ref_wl, port_wl = _statics(["deit-t"])
    cons, carry = _bounds(1)
    emu = emulate_padded(cfg, mask, cons, carry, port_wl)
    assert emu[2, 0] > SPLIT and 0 <= emu[1, 0] < pk.BLOCK // SPLIT
    assert np.array_equal(emu, pk.dse_search_padded(
        _t(cfg), _t(mask), _t(cons), _t(carry), workloads=port_wl,
        constants=C).numpy())
    assert np.array_equal(emu, _pallas(
        rk.dse_search_padded, cfg, mask, cons, carry, workloads=ref_wl,
        constants=REF_C))


def test_decoded_tie_across_ctas_takes_the_lowest_lane():
    # Every candidate value twice: each config sits at 32 indices of the
    # block, in several of its CTAs, so the best EDP ties across them.
    axes_t = tuple((1, 1, 2, 2, 3, 3, 4, 4) for _ in range(4)) \
        + ((1, 1, 2, 2),)
    arr = np.asarray([list(a) + [1.0] * (8 - len(a)) for a in axes_t],
                     np.float32)
    radices = tuple(len(a) for a in axes_t)
    meta = np.asarray([0, int(np.prod(radices))]
                      + [v for a in axes_t for v in (0, len(a))], np.int32)
    ref_wl, port_wl = _statics(["deit-t"])
    cons, carry = _bounds(1)
    emu = emulate_decoded(arr, meta, cons, carry, radices, 1, port_wl)
    cols, valid, _, _ = decoded_lanes(arr, meta, radices, 1)
    winner = tuple(col[int(emu[1, 0])] for col in cols)
    twins = np.flatnonzero(np.all([col == x for col, x in zip(cols, winner)],
                                  axis=0) & valid)
    sub = pk.DECODE_BLOCK // SPLIT
    assert twins[0] == emu[1, 0] and len(set(twins // sub)) > 1
    assert np.array_equal(emu, pk.dse_search_decoded(
        _t(arr), _t(meta), _t(cons), _t(carry), radices=radices, n_blocks=1,
        workloads=port_wl, constants=C).numpy())
    assert np.array_equal(emu, _pallas(
        rk.dse_search_decoded, arr, meta[None, :], cons, carry,
        radices=radices, n_blocks=1, workloads=ref_wl, constants=REF_C))


@pytest.mark.parametrize("where", ["24^5 first blocks", "24^5 slab",
                                   "12^5 odd start"])
def test_run_walk_digits_match_decode_digits(where):
    from repro_torch.core import FactorizedSpace
    from repro_torch.core.factorized import slab_bounding_span
    side = 12 if where.startswith("12") else 24
    radices = FactorizedSpace.full(side).radices
    if where == "24^5 slab":
        start, _ = slab_bounding_span(
            radices, ((0, 3), (0, 4), (4, 20), (2, 18), (8, 16)))
    else:
        start = 12345 if where == "12^5 odd start" else 0
    n = 2 * pk.DECODE_BLOCK
    got = run_digits(radices, start, n)
    want = decode_digits(start + np.arange(n, dtype=np.int64), radices)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_hoisted_area_power_prefix_is_bit_identical(name):
    # The prefix from the terms above lambda plus the workload's tail
    # equals the plain _config_metrics_hw, on every config of a 4096 draw.
    cfg = _cfg(np.random.default_rng(5), 4096)
    ((gemms, scalars),) = _statics([name])[1]
    k = [f32(x) for x in pk._folded_constants(C)]
    wl = pk._folded_workload(scalars, C)
    t, c, h, v, l = cfg
    a_pre, q_pre = hw_prefix_lane(k, upper_terms(k, t, c, h, v), l)
    area = (a_pre + f32(wl[0])) + k[A_CHIP]
    power = (q_pre + f32(wl[1])) + k[P_CHIP]
    kc, per = pk._statics(((gemms, scalars),), C)
    want = pk._config_metrics_hw(kc, per[0][0], *(torch.from_numpy(x)
                                                   for x in cfg))
    assert np.array_equal(area, want[0].numpy())
    assert np.array_equal(power, want[1].numpy())


def test_meta_rows_feed_the_emulation():
    # The emulation's decoded layout agrees with the plain decoder's on a
    # slab meta row built as the branch-and-bound search builds it.
    radices = tuple(len(a) for a in AXES)
    meta = ops._meta_rows(radices, [777], 20000,
                          ((1, 7), (0, 8), (2, 5), (1, 8), (0, 6)))[0]
    cols, valid, _, _ = decoded_lanes(_axes_operand(), meta, radices, 2)
    pcols, _, pvalid = pk._decode_block_plain(
        radices, _t(_axes_operand()), _t(meta), 2, pk.DECODE_BLOCK)
    assert np.array_equal(valid, pvalid.numpy())
    for a, b in zip(cols, pcols):
        assert np.array_equal(a[valid], b.numpy()[valid])
