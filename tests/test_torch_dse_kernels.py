"""The port's four DSE kernels, held against the Pallas kernels they replace.

For each of `dse_eval_padded`, `dse_search_padded`, `dse_search_decoded` and
`dse_decode_rows`, the port's wrapper is given CPU tensors (so it runs the
kernel's plain PyTorch version) and the reference Pallas kernel runs in
interpret mode on the same numpy inputs, made from a seed. Tolerance: exact —
the raw output arrays must be equal bit for bit (`np.array_equal`).

The reference is compiled by XLA with its algebraic simplifier off and the
LLVM backend at -O0 (`STRICT`), so the interpreted kernel's float32
arithmetic runs as its source writes it, which is what the CUDA kernels and
their plain versions implement. XLA's default CPU pipeline rewrites that
arithmetic (a division by a constant becomes a reciprocal multiply, chained
constant additions fold, multiply-adds contract into FMAs);
`test_default_xla_pipeline_moves_interpret_output` pins that divergence.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.paper_workloads import PAPER_WORKLOADS, load
from repro.core.performance_model import workload_statics as ref_statics
from repro.core.photonic_model import CONSTANTS as REF_C
from repro.kernels import dse_eval as rk
from repro_torch.core.performance_model import workload_statics
from repro_torch.interop import from_reference
from repro_torch.kernels import dse_eval as pk

STRICT = {"xla_disable_hlo_passes": "algsimp",
          "xla_backend_optimization_level": 0}
C = from_reference(REF_C)
NAMES = sorted(PAPER_WORKLOADS)


def _pallas(fn, *args, options=STRICT, **static):
    """The reference kernel in interpret mode, compiled with `options`."""
    f = functools.partial(fn, interpret=True, **static)
    args = [jnp.asarray(a) for a in args]
    return np.asarray(jax.jit(f).lower(*args).compile(options)(*args))


def _statics(names):
    ref = tuple(ref_statics(load(n), REF_C) for n in names)
    port = tuple(workload_statics(from_reference(load(n)), C)
                 for n in names)
    assert ref == port
    return ref, port


def _cfg(rng, g):
    return rng.integers(1, 13, size=(5, g)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", NAMES)
def test_dse_eval_padded_matches_pallas(name):
    cfg = _cfg(np.random.default_rng(11), 3001)  # partial last block
    ((g, s),), ((pg, ps),) = _statics([name])
    ref = _pallas(rk.dse_eval_padded, cfg, gemms=g, wl_scalars=s,
                  constants=REF_C)
    got = pk.dse_eval_padded(_t(cfg), gemms=pg, wl_scalars=ps, constants=C)
    assert np.array_equal(got.numpy(), ref)


def _search_case(case):
    """(cfg, mask, cons, carry) of one dse_search_padded parity case; three
    workloads, paper-sized bounds unless the case says otherwise."""
    rng = np.random.default_rng(sum(map(ord, case)))
    g = 5000 if case == "masked" else 4096
    cfg = _cfg(rng, g)
    mask = np.ones((1, g), np.float32)
    cons = np.tile(np.asarray([[60.0, 15.0, 0.1, 5e-3]], np.float32),
                   (3, 1))
    carry = np.full((3, 1), np.inf, np.float32)
    if case == "masked":
        mask[0, rng.random(g) < 0.3] = 0.0
    elif case == "infeasible":
        cons[1] = [1.0, 0.01, 1e-12, 1e-12]          # nothing passes
        cons[2, 0] = 12.0                             # area kills most
    elif case == "ties":
        cfg[:, 1::2] = cfg[:, 0::2]                   # every EDP twice
    elif case == "carry":
        carry[:] = 0.0                                # carry beats all
        carry[2] = np.inf
    return cfg, mask, cons, carry


SEARCH_CASES = ["plain", "masked", "infeasible", "ties", "carry"]


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_dse_search_padded_matches_pallas(case):
    cfg, mask, cons, carry = _search_case(case)
    names = ["deit-t", "bert-b", "deit-b"]
    ref_wl, port_wl = _statics(names)
    ref = _pallas(rk.dse_search_padded, cfg, mask, cons, carry,
                  workloads=ref_wl, constants=REF_C)
    got = pk.dse_search_padded(_t(cfg), _t(mask), _t(cons), _t(carry),
                               workloads=port_wl, constants=C).numpy()
    assert np.array_equal(got, ref)
    if case == "plain":
        # A carry equal to a block's own best EDP wins the tie.
        carry[:, 0] = got[0::pk.SEARCH_ROWS, 1]
        ref = _pallas(rk.dse_search_padded, cfg, mask, cons, carry,
                      workloads=ref_wl, constants=REF_C)
        tied = pk.dse_search_padded(_t(cfg), _t(mask), _t(cons), _t(carry),
                                    workloads=port_wl, constants=C).numpy()
        assert np.array_equal(tied, ref)
        assert (tied[1::pk.SEARCH_ROWS, 1] == pk.CARRY_IDX).all()


# An uneven product space of 8 * 8 * 6 * 8 * 7 = 21504 points: two decoded
# blocks of DECODE_BLOCK lanes, the second partial.
AXES = ((1, 2, 3, 4, 5, 6, 8, 12), (1, 2, 3, 4, 6, 8, 10, 12),
        (2, 4, 6, 8, 10, 12), (1, 2, 4, 5, 6, 8, 9, 12),
        (1, 2, 4, 6, 8, 10, 12))
SIZE = int(np.prod([len(a) for a in AXES]))


def _axes_operand():
    arr = np.ones((5, max(len(a) for a in AXES)), np.float32)
    for i, a in enumerate(AXES):
        arr[i, :len(a)] = a
    return arr


def _meta(start, end, slab=None):
    ranges = slab or tuple((0, len(a)) for a in AXES)
    return np.asarray([start, end] + [v for r in ranges for v in r],
                      np.int32)


SLAB = ((1, 7), (2, 6), (0, 5), (3, 8), (1, 4))
# case -> (meta row, blocks past those the span needs: all-invalid lanes)
DECODE_CASES = {
    "full": (_meta(0, SIZE), 0),
    "offset": (_meta(5000, 17000), 0),
    "slab": (_meta(0, SIZE, SLAB), 0),
    "dead_tail": (_meta(0, SIZE), 1),
}


def _n_blocks(case, block):
    meta, extra = DECODE_CASES[case]
    return -(-int(meta[1] - meta[0]) // block) + extra


@pytest.mark.parametrize("case", sorted(DECODE_CASES) + ["carry_tie"])
def test_dse_search_decoded_matches_pallas(case):
    meta = DECODE_CASES.get(case, DECODE_CASES["full"])[0]
    n_blocks = _n_blocks(case if case in DECODE_CASES else "full",
                         pk.DECODE_BLOCK)
    names = ["deit-s", "bert-l"]
    ref_wl, port_wl = _statics(names)
    cons = np.tile(np.asarray([[60.0, 15.0, 0.1, 5e-3]], np.float32),
                   (2, 1))
    carry = np.full((2, 1), np.inf, np.float32)
    radices = tuple(len(a) for a in AXES)
    axes = _axes_operand()

    def both(carry):
        ref = _pallas(rk.dse_search_decoded, axes, meta[None, :], cons,
                      carry, radices=radices, n_blocks=n_blocks,
                      workloads=ref_wl, constants=REF_C)
        got = pk.dse_search_decoded(
            _t(axes), _t(meta), _t(cons), _t(carry), radices=radices,
            n_blocks=n_blocks, workloads=port_wl, constants=C).numpy()
        assert np.array_equal(got, ref)
        return got

    got = both(carry)
    if case == "carry_tie":
        carry[:, 0] = got[0::pk.SEARCH_ROWS, 0]      # block 0's best EDPs
        tied = both(carry)
        assert (tied[1::pk.SEARCH_ROWS, 0] == pk.CARRY_IDX).all()


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_dse_decode_rows_matches_pallas(case):
    meta = DECODE_CASES[case][0]
    n_blocks = _n_blocks(case, pk.BLOCK)
    radices = tuple(len(a) for a in AXES)
    axes = _axes_operand()
    ref = _pallas(rk.dse_decode_rows, axes, meta[None, :], radices=radices,
                  n_blocks=n_blocks)
    got = pk.dse_decode_rows(_t(axes), _t(meta), radices=radices,
                             n_blocks=n_blocks).numpy()
    assert np.array_equal(got, ref)


def test_cpu_tensors_launch_no_kernel():
    # The wrappers count a launch only where they launch a CUDA kernel; a
    # CPU tensor takes the plain version and leaves every count at 0.
    pk.reset_launch_counts()
    ((g, s),) = _statics(["deit-t"])[1]
    pk.dse_eval_padded(_t(_cfg(np.random.default_rng(0), 100)), gemms=g,
                       wl_scalars=s, constants=C)
    assert set(pk.LAUNCHES.values()) == {0}


def test_default_xla_pipeline_moves_interpret_output():
    # Under XLA's default CPU pipeline the interpreted kernel's float32
    # values move by a few ulps on a large share of configs (the rewrites
    # named in the module docstring); the strict compile removes exactly
    # that. The port follows the kernel source, not the rewrites.
    cfg = _cfg(np.random.default_rng(3), 4096)
    ((g, s),), _ = _statics(["deit-t"])
    kw = dict(gemms=g, wl_scalars=s, constants=REF_C)
    strict = _pallas(rk.dse_eval_padded, cfg, **kw)
    default = _pallas(rk.dse_eval_padded, cfg, options={}, **kw)
    assert not np.array_equal(strict, default)
    ulps = np.abs(strict.view(np.int32).astype(np.int64)
                  - default.view(np.int32).astype(np.int64))
    assert ulps.max() <= 8
