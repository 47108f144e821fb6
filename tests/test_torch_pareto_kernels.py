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
