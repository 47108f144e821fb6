"""Decode on a sequence-sharded cache across real ranks (CPU): a gloo group
of 2 ranks (DECODE_RULES on a (1, 2) mesh) and one of 4 (DECODE_RULES on
(2, 2), LONG_DECODE_RULES on (1, 4)), spawned at once, each rank a process
running tests/torch_seq_sharded_ranks.py with one intra-op thread. A mesh
of one device cannot show a row written on the wrong shard or a partial
reduction left out; these can.

For each layout and reduced arch (qwen2.5-3b; gemma3-4b with its windows
and a logit softcap; deepseek-v3-671b's MLA; zamba2-7b's hybrid;
seamless-m4t-medium's enc-dec with its cross-attention) two decode steps
with DTensor parameters and cache, against the plain NULL_RULES run:
every cache entry bit-equal, the logits within LOGIT_RTOL of their largest
magnitude (f32 products on the CPU: the split softmax and the sharded
products differ from the plain run only in the order of summation),
nothing gathered by `GatherFallback`, no view that flattens a sharded
dimension that does not lead its group (`parallel.sharding.StridedViews`),
and the split path taken (softmaxes over split keys, rows written on their
shard). `write_row` at every
position of a cache laid out each way `Rules.kv_cache` and DTensor give
(plain shards of T over one or both mesh dimensions, a strided shard, a
sharded batch or heads beside it) equals the plain write.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tests", "torch_seq_sharded_ranks.py")
LOGIT_RTOL = 1e-5
TIMEOUT_S = 300
ARCHS = ("qwen2.5-3b", "gemma3-4b", "deepseek-v3-671b", "zamba2-7b",
         "seamless-m4t-medium")
LAYOUTS = ("decode (1, 2)", "decode (2, 2)", "long decode (1, 4)")
WRITE_LAYOUTS = ("T over model", "T over both", "T over data, model",
                 "T strided over data, model", "B over data, T over model",
                 "T over model alone", "T over data, heads over model")


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    """Rank 0's JSON lines of both groups, keyed by layout (and arch)."""
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
                out[r.get("write_layout") or (r["layout"], r["arch"])] = r
    assert not failed, "\n".join(failed)
    return out


@pytest.mark.parametrize("layout", WRITE_LAYOUTS)
def test_write_row_on_its_shard_equals_the_plain_write(rows, layout):
    assert rows[layout]["equal"], rows[layout]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_sharded_decode_matches_the_plain_run(rows, layout, arch):
    r = rows[(layout, arch)]
    assert r["cache_bit_equal"], r
    assert r["max_abs_diff"] <= LOGIT_RTOL * r["max_abs_logit"], r
    assert r["gathered"] == {}, r
    assert r["strided_views"] == {}, r
    assert r["split_softmax"] > 0 and r["sharded_writes"] > 0, r
