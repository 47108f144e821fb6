"""The k-shard launchers of kernels 2, 3, 5 and 6 and the candidate specs,
against the reference.

The reference's `shard_map` launches need k devices, so its k = 4 run is
made in one subprocess under
`XLA_FLAGS=--xla_force_host_platform_device_count=4`, with its Pallas
kernels in interpret mode compiled `STRICT` (XLA's algebraic simplifier off,
LLVM at -O0: `tests/test_torch_dse_kernels.py` says why — XLA's default CPU
pipeline moves the interpreted float32 by an ulp). The port's launchers are
given the CPU four times, `(cpu,) * 4`, so each shard runs its kernel's
plain PyTorch version. Inputs are made from a seed with numpy: a grid of
5,003 rows for the padded kernels (two workloads, a carried EDP and a
carried front), a 720-point product space with a slab for the decoded
ones. Tolerance: exact — the raw per-block columns, the shard size, the
blocks per shard and each block's first index are equal.

`sanitize_spec` and `candidate_spec` are held against the reference's on
random shapes, specs and axis sizes (a hypothesis property test, or the
repository's stand-in where hypothesis is absent).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover — images without hypothesis
    from _hypothesis_fallback import given, settings, st

from jax.sharding import PartitionSpec

from repro.core.paper_workloads import load
from repro.core.photonic_model import CONSTANTS as REF_C
from repro.parallel import sharding as r_sharding
from repro_torch.core.factorized import FactorizedSpace
from repro_torch.core.performance_model import workload_statics
from repro_torch.interop import from_reference
from repro_torch.kernels import ops as p_ops
from repro_torch.parallel import sharding as p_sharding

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAMES = ("deit-t", "bert-l")
AXES = ((1, 2, 3, 4, 5), (1, 2, 3, 4), (2, 4, 6), (1, 3, 5, 7), (4, 8, 12))
SLAB = ((1, 4), (0, 3), (0, 3), (1, 4), (0, 2))
OBJS = ("area", "power", "edp")
C = from_reference(REF_C)
CPU4 = (torch.device("cpu"),) * 4

# The reference's k = 4 launches, each compiled STRICT: the subprocess
# wraps the shard_map executables so every call lowers and compiles with
# the STRICT options, then calls the reference's own sharded launchers.
REFERENCE_K4 = r"""
import sys
import jax
import jax.numpy as jnp
import numpy as np
from repro.core.factorized import FactorizedSpace
from repro.core.paper_workloads import load
from repro.core.performance_model import workload_statics
from repro.core.photonic_model import CONSTANTS
from repro.core.arch_params import Constraints
from repro.kernels import ops

STRICT = {"xla_disable_hlo_passes": "algsimp",
          "xla_backend_optimization_level": 0}
assert len(jax.devices()) == 4, jax.devices()


class Strict:
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        args = [jnp.asarray(a) for a in args]
        return self.fn.lower(*args).compile(STRICT)(*args)


for name in ("_sharded_kernel_fn", "_sharded_decoded_fn"):
    real = getattr(ops, name)
    setattr(ops, name, lambda *a, _real=real: Strict(_real(*a)))

inp = np.load(sys.argv[1])
names = ("deit-t", "bert-l")
wls = tuple(workload_statics(load(n), CONSTANTS) for n in names)
cons = ops._constraint_rows([Constraints(), Constraints(power_w=6.0)])
search_carry = ops._search_carry_rows(list(inp["carry_edp"]), 2)
front_carry = ops._front_carry_rows([inp["carry_pts"], None], 2, 3)
objs = ("area", "power", "edp")
out = {}
out["k2"], out["k2_ss"], out["k2_bps"] = ops._sharded_kernel_out(
    inp["grid"], 4, "search", (wls, CONSTANTS, True), cons, search_carry)
out["k5"], out["k5_ss"], out["k5_bps"] = ops._sharded_kernel_out(
    inp["grid"], 4, "pareto", (wls, objs, True, CONSTANTS, True), cons,
    front_carry)
space = FactorizedSpace(tuple(tuple(int(v) for v in a if v)
                              for a in inp["axes"]))
slab = tuple(tuple(int(v) for v in r) for r in inp["slab"])
out["k3"], out["k3_lo"] = ops._decoded_launch(
    space, 37, 600, "search", (wls, CONSTANTS, True), cons, search_carry, 4,
    slab)
out["k6"], out["k6_lo"] = ops._decoded_launch(
    space, 0, space.size, "pareto", (wls, objs, True, CONSTANTS, True), cons,
    front_carry, 4)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These cases run many small torch ops; beside other test processes
    on the same cores, intra-op thread pools spin against each other and
    slow them tenfold. One thread a process (restored after the file)
    gives the same results: every reduction here is exact."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def k4(tmp_path_factory):
    """(inputs, the reference's k = 4 outputs), made once for the file."""
    d = tmp_path_factory.mktemp("k4")
    rng = np.random.default_rng(4)
    grid = rng.integers(1, 13, size=(5003, 5))
    pw = from_reference(load("deit-t"))
    m = p_ops.dse_eval_grid(grid[:6], pw, C, device="cpu")
    carry_pts = np.stack([m[:, 0], m[:, 1], m[:, 2] * m[:, 3]], axis=1)
    axes = np.zeros((5, 5), np.int64)
    for i, a in enumerate(AXES):
        axes[i, :len(a)] = a
    np.savez(d / "in.npz", grid=grid, carry_pts=carry_pts,
             carry_edp=np.asarray([np.inf, 2e-5]), axes=axes,
             slab=np.asarray(SLAB))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", REFERENCE_K4, str(d / "in.npz"),
                    str(d / "out.npz")], check=True, env=env, cwd=ROOT)
    return np.load(d / "in.npz"), np.load(d / "out.npz")


def _port_operands(inp):
    from repro_torch.core.arch_params import Constraints
    wls = tuple(workload_statics(from_reference(load(n)), C) for n in NAMES)
    cons = p_ops._constraint_rows([Constraints(), Constraints(power_w=6.0)])
    return (wls, cons, p_ops._search_carry_rows(list(inp["carry_edp"]), 2),
            p_ops._front_carry_rows([inp["carry_pts"], None], 2, 3))


def test_padded_k4_launches_equal_the_references(k4):
    inp, ref = k4
    wls, cons, search_carry, front_carry = _port_operands(inp)
    out, ss, bps = p_ops._sharded_padded("search", inp["grid"], CPU4, wls, C,
                                         cons, search_carry)
    assert (ss, bps) == (int(ref["k2_ss"]), int(ref["k2_bps"]))
    assert out.shape == (6, 4 * bps)
    assert np.array_equal(out, ref["k2"])
    out, ss, bps = p_ops._sharded_padded("pareto", inp["grid"], CPU4, wls, C,
                                         cons, front_carry, OBJS, True)
    assert (ss, bps) == (int(ref["k5_ss"]), int(ref["k5_bps"]))
    assert np.array_equal(out, ref["k5"])


def test_decoded_k4_launches_equal_the_references(k4):
    inp, ref = k4
    wls, cons, search_carry, front_carry = _port_operands(inp)
    space = FactorizedSpace(AXES)
    out, blk_lo = p_ops._decoded_launch(space, 37, 600, "search", wls, C,
                                        cons, search_carry, "cpu", SLAB,
                                        mesh=CPU4)
    assert np.array_equal(out, ref["k3"])
    assert np.array_equal(blk_lo, ref["k3_lo"])
    out, blk_lo = p_ops._decoded_launch(space, 0, space.size, "pareto", wls,
                                        C, cons, front_carry, "cpu", None,
                                        OBJS, True, mesh=CPU4)
    assert np.array_equal(out, ref["k6"])
    assert np.array_equal(blk_lo, ref["k6_lo"])


def test_k4_wrappers_rebase_to_the_unsharded_answer(monkeypatch):
    """The public wrappers reduce a k = 4 launch (the CPU given four times
    as the mesh) to the unsharded launch's answer: indices rebased in
    int64, ties to the lowest global index, an overflowing block's
    whole-block fallback at its global base."""
    import json

    from repro_torch.core.arch_params import Constraints
    from repro_torch.launch import mesh
    pw = from_reference(load("deit-t"))
    golden = json.loads((ROOT / "tests" / "golden" / "dse_12x5.json")
                        .read_text())
    winner = np.asarray(golden["workloads"]["deit-t"]["best"])
    grid = np.random.default_rng(8).integers(1, 13, size=(9001, 5))
    dup = np.concatenate([grid[:3000], np.tile(winner, (2100, 1)),
                          grid[3000:]])
    space = FactorizedSpace(AXES)
    box = Constraints()

    def run(shard):
        return (p_ops.dse_search_grid(dup, pw, box, C, "cpu", shard=shard),
                p_ops.dse_pareto_multi(dup, [pw], [box], C, "cpu",
                                       shard=shard)[0],
                p_ops.dse_search_multi_factorized(
                    space, 3, 700, [pw], [box], C, "cpu", shard=shard,
                    slab=SLAB),
                p_ops.dse_pareto_multi_factorized(
                    space, 0, space.size, [pw], [box], C, "cpu",
                    shard=shard)[0])

    s0, p0, f0, q0 = run(None)
    monkeypatch.setattr(mesh, "make_candidate_mesh", lambda s, d=None: CPU4)
    s4, p4, f4, q4 = run(4)
    assert s4 == s0 and f4 == f0
    for (a, na, oa), (b, nb, ob) in ((p0, p4), (q0, q4)):
        assert np.array_equal(a, b) and (na, oa) == (nb, ob)
    assert p4[2] >= 1  # the 2,100 copies of the winner overflow a block
    assert s4[0] == 3000  # the first copy of the winner: a tie to the lowest


# ---------------------------------------------------------------------------
# Candidate specs: the reference's, entry for entry
# ---------------------------------------------------------------------------

AXIS_NAMES = ("candidates", "data", "model")


def _random_case(rank, seed):
    rng = np.random.default_rng(seed)
    shape = tuple(int(x) for x in rng.choice([1, 2, 3, 4, 6, 8, 16], rank))
    sizes = {a: int(x) for a, x in zip(AXIS_NAMES,
                                       rng.choice([1, 2, 3, 4], 3))}
    spec = []
    for _ in range(int(rng.integers(0, rank + 1))):
        pick = int(rng.integers(0, 4))
        if pick == 0:
            spec.append(None)
        elif pick == 3:
            spec.append(tuple(str(a) for a in rng.choice(AXIS_NAMES, 2,
                                                          replace=False)))
        else:
            spec.append(str(rng.choice(AXIS_NAMES)))
    return shape, tuple(spec), sizes


@settings(max_examples=60)
@given(st.tuples(st.integers(1, 4), st.integers(0, 10 ** 6)))
def test_sanitize_spec_is_the_references(args):
    shape, spec, sizes = _random_case(*args)
    want = r_sharding.sanitize_spec(shape, PartitionSpec(*spec), sizes)
    got = p_sharding.sanitize_spec(shape, spec, sizes)
    assert got == tuple(want), (shape, spec, sizes)


def test_candidate_spec_is_the_references():
    assert p_sharding.CANDIDATE_AXIS == r_sharding.CANDIDATE_AXIS
    for rank in range(1, 4):
        for dim in range(rank):
            assert p_sharding.candidate_spec(rank, dim) == \
                tuple(r_sharding.candidate_spec(rank, dim))
    spec = p_sharding.candidate_spec(2, 1)
    axis = {p_sharding.CANDIDATE_AXIS: 4}
    assert p_sharding.sanitize_spec((5, 8192), spec, axis) == spec
    # an indivisible candidate dim degrades: re-homed, else replicated
    assert p_sharding.sanitize_spec((4, 8190), spec, axis) == \
        ("candidates", None)
    assert p_sharding.sanitize_spec((5, 8190), spec, axis) == (None, None)
