"""The rules on a real one-device mesh (a gloo group of one rank, in a
subprocess: tests/torch_one_device_rules.py): DTensor parameters laid out
by `param_specs` give prefill logits, a decode step (logits and cache), a
train step (loss, norm, every updated parameter) and two checkpointed
`Trainer(shardings=)` steps bit-equal to the plain NULL_RULES run, through
the entry points alone (no context opened by the caller); `shard_batch`
keeps the batch's values."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def test_one_device_dtensor_rules_are_bit_equal_to_null_rules(tmp_path):
    arch = "qwen2.5-3b"
    script = os.path.join(os.path.dirname(__file__),
                          "torch_one_device_rules.py")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, script, str(tmp_path / "store"),
                        arch], env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln]
    assert lines == ["prefill bit-equal", "decode bit-equal",
                     "train bit-equal", "trainer bit-equal",
                     "shard_batch equal"], r.stdout + r.stderr
