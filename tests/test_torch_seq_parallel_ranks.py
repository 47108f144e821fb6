"""Sequence-parallel prefill and a sharded train step across real ranks
(CPU): a gloo group of 2 ranks (PREFILL_RULES and TRAIN_RULES on a (1, 2)
mesh) and one of 4 (PREFILL_RULES on (1, 4), TRAIN_RULES with FSDP on
(2, 2)), spawned at once, each rank a process running
tests/torch_seq_parallel_ranks.py with one intra-op thread.

For each layout and reduced arch (qwen2.5-3b; gemma3-4b with its windows
and a logit softcap; deepseek-v3-671b's MLA and MoE; zamba2-7b's SSD;
rwkv6-7b's WKV; seamless-m4t-medium's enc-dec) with DTensor parameters
from `parallel.specs`, against the plain NULL_RULES run on the same seeded
inputs, at the tolerances the port's parity tests hold against the
reference: prefill logits within LOGIT_TOL, a train step's loss within
LOSS_TOL and every gradient leaf within GRAD_RTOL of its largest magnitude
(RWKV_GRAD_RTOL for rwkv6-7b); no f32 DTensor holding a Partial sum cast to
bf16; no view in the products' lowering or the MoE dispatch's merges that
flattens a sharded dimension that does not lead its group
(`parallel.sharding.StridedViews`). The attention and MLP blocks on 4 ranks give bf16 outputs within one
bf16 ulp of the plain block's, element for element, which a row-parallel
product's partial sums rounded to bf16 before their sum break.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "torch_seq_parallel_ranks.py")
LOGIT_TOL, LOSS_TOL = 0.03, 0.06
GRAD_RTOL, RWKV_GRAD_RTOL = 2.0 ** -5, 2.0 ** -4
TIMEOUT_S = 420
ARCHS = ("qwen2.5-3b", "gemma3-4b", "deepseek-v3-671b", "zamba2-7b",
         "rwkv6-7b", "seamless-m4t-medium")
PREFILL = ("prefill (1, 2)", "prefill (1, 4)")
TRAIN = ("train (1, 2)", "train (2, 2)")


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """Rank 0's JSON lines of both groups, keyed by block or by (layout,
    arch)."""
    d = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    procs = []
    for world in (2, 4):
        store = str(d / f"store{world}")
        for rank in range(world):
            procs.append((world, rank, subprocess.Popen(
                [sys.executable, SCRIPT, store, str(world), str(rank)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    out, failed = {}, []
    for world, rank, p in procs:
        try:
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for *_, q in procs:
                q.kill()
            raise
        if p.returncode:
            failed.append(f"world {world} rank {rank}: {stderr[-3000:]}")
        for line in stdout.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                out[r.get("block") or (r["layout"], r["arch"])] = r
    assert not failed, "\n".join(failed)
    return out


def _lowering_sites(strided_views):
    """The sites among `strided_views` (`parallel.sharding.StridedViews`'
    counts by model site) in the products' lowering (`layers._Plan`) and
    the MoE dispatch's merges (`moe._merged`), which flatten no sharded
    dimension that does not lead its group; the SSD's and WKV's own
    einsums and reshapes, `matmul16` and the backward's views still do
    (ROADMAP Queue 3)."""
    return {k: n for k, n in strided_views.items()
            if k.endswith((" operands", " _merged"))}


@pytest.mark.parametrize("block", ["attention", "mlp"])
def test_block_within_one_bf16_ulp_of_the_plain_block(rows, block):
    r = rows[block]
    assert r["elements"] > 0 and r["beyond_one_ulp"] == 0, r


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", PREFILL)
def test_sharded_prefill_matches_the_plain_run(rows, layout, arch):
    r = rows[(layout, arch)]
    assert r["max_abs_diff"] <= LOGIT_TOL, r
    assert r["partial_casts"] == 0, r
    assert not _lowering_sites(r["strided_views"]), r


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", TRAIN)
def test_sharded_train_step_matches_the_plain_run(rows, layout, arch):
    r = rows[(layout, arch)]
    tol = RWKV_GRAD_RTOL if arch == "rwkv6-7b" else GRAD_RTOL
    assert r["same_leaves"] and r["grad_leaves"] > 0, r
    assert r["loss_diff"] <= LOSS_TOL, r
    assert r["grad_rel"] <= tol, r
    assert r["partial_casts"] == 0, r
    assert not _lowering_sites(r["strided_views"]), r
