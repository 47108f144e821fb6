"""`launch.train --coordinator` (CPU): every rank trains the whole model.

The reference's launcher, run with `--coordinator` in two JAX CPU
processes, trains the same model in each (`jax.distributed` and then
`NULL_RULES`, no shardings): both print the same line. The module fixture
runs that pair for 2 steps (`--ckpt-every 2`, a directory each), then from
copies of their step-2 checkpoints, at the same time: the port's two gloo
ranks (`--coordinator 127.0.0.1:<port> --device cpu`), a one-process port
run and a one-process reference run, 2 steps each. The port's ranks end at
step 4 with losses equal to each other's and to the one-process port
run's bit for bit (the same model, batches and arithmetic in each
process), and their last loss within LOSS_ATOL of the reference's
continuation (`tests/test_torch_train_resume.py`'s tolerance) plus half a
unit of the 4 decimals the reference prints.

Cheap in-process cases: a one-rank group leaves no group behind, whether
`main` returns or raises; the rank count and rank come from the flags or
`WORLD_SIZE` / `RANK`, else a ValueError names the flag before any group
exists; a plain `cuda` becomes the rank's card, and a card's group is NCCL
bound to it (checked with the group's constructor stubbed: there is no
card here).
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import train as launch_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 0.06
PRINT_ATOL = 5e-5
TIMEOUT_S = 120
ARGS = ["--arch", "granite-3-2b", "--reduced", "--steps", "2",
        "--ckpt-every", "2"]
# The port's launcher in a subprocess, printing its losses exactly.
PORT_MAIN = ("import json, sys; from repro_torch.launch import train; "
             "out = train.main(sys.argv[1:]); "
             "print('LOSSES', json.dumps(out['losses']), out['final_step'])")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_all(argvs):
    """Run the argvs at once from the repo root; every process is killed
    if they are not all done within TIMEOUT_S. [(rc, stdout, stderr)]."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, *a], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for a in argvs]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append((p.returncode, out, err))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _coordinator(port, rank):
    return ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--process-id", str(rank)]


def _done(out):
    return [ln for ln in out.splitlines() if ln.startswith("done:")]


def _port_losses(out):
    line = [ln for ln in out.splitlines() if ln.startswith("LOSSES ")][-1]
    losses, step = line[len("LOSSES "):].rsplit(" ", 1)
    return json.loads(losses), int(step)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("coordinator")
    ref_port, port_port = _free_port(), _free_port()
    ref_dirs = [base / f"ref{r}" for r in (0, 1)]
    first = _run_all([["-m", "repro.launch.train", *ARGS, *_coordinator(
        ref_port, r), "--ckpt-dir", str(d)] for r, d in enumerate(ref_dirs)])
    for rc, out, err in first:
        assert rc == 0, out + err
    copies = {}
    for name, src in (("port0", ref_dirs[0]), ("port1", ref_dirs[1]),
                      ("port_one", ref_dirs[0]), ("ref_one", ref_dirs[0])):
        copies[name] = base / f"copy_{name}"
        shutil.copytree(src, copies[name])
    port = ["-c", PORT_MAIN, *ARGS, "--device", "cpu"]
    second = _run_all(
        [[*port, *_coordinator(port_port, r), "--ckpt-dir",
          str(copies[f"port{r}"])] for r in (0, 1)]
        + [[*port, "--ckpt-dir", str(copies["port_one"])],
           ["-m", "repro.launch.train", *ARGS, "--ckpt-dir",
            str(copies["ref_one"])]])
    return {"ref_pair": first, "port_pair": second[:2],
            "port_one": second[2], "ref_one": second[3]}


def test_reference_processes_train_the_same_model(runs):
    lines = [_done(out) for _, out, _ in runs["ref_pair"]]
    assert lines[0] == lines[1] and len(lines[0]) == 1
    assert lines[0][0].startswith("done: step 2,")


def test_port_ranks_equal_a_one_process_run(runs):
    rc, out, err = runs["port_one"]
    assert rc == 0, out + err
    want, step = _port_losses(out)
    assert step == 4 and len(want) == 2
    for rc, out, err in runs["port_pair"]:
        assert rc == 0, out + err
        assert _port_losses(out) == (want, 4)


def test_port_ranks_hold_the_reference_continuation(runs):
    rc, out, err = runs["ref_one"]
    assert rc == 0, out + err
    line = _done(out)[-1]
    assert line.startswith("done: step 4,")
    want = float(line.split("loss ")[1].split(",")[0])
    for _, out, _ in runs["port_pair"]:
        got = _port_losses(out)[0][-1]
        assert abs(got - want) <= LOSS_ATOL + PRINT_ATOL, (got, want)


def _one_rank(tmp_path, *extra):
    return ["--arch", "granite-3-2b", "--reduced", "--steps", "1",
            "--ckpt-dir", str(tmp_path), "--coordinator",
            f"127.0.0.1:{_free_port()}", *extra]


def test_one_rank_group_is_gone_after_main(tmp_path):
    assert not dist.is_initialized()
    out = launch_train.main(_one_rank(tmp_path / "a", "--num-processes",
                                      "1", "--process-id", "0", "--device",
                                      "cpu"))
    assert not dist.is_initialized()
    plain = launch_train.main(["--arch", "granite-3-2b", "--reduced",
                               "--steps", "1", "--ckpt-dir",
                               str(tmp_path / "b"), "--device", "cpu"])
    assert out["final_step"] == 1 and out["losses"] == plain["losses"]


def test_one_rank_group_is_gone_after_a_failure(tmp_path, monkeypatch):
    seen = []

    def failing(args, device):
        seen.append((dist.is_initialized(), dist.get_backend(), device))
        raise RuntimeError("training failed")

    monkeypatch.setattr(launch_train, "_train", failing)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="training failed"):
        launch_train.main(_one_rank(tmp_path, "--device", "cpu"))
    assert seen == [(True, "gloo", torch.device("cpu"))]
    assert not dist.is_initialized()


@pytest.mark.parametrize("flags,var,flag", [
    (["--process-id", "0"], "WORLD_SIZE", "--num-processes"),
    (["--num-processes", "2"], "RANK", "--process-id")])
def test_missing_rank_count_or_rank_raises(tmp_path, monkeypatch, flags,
                                           var, flag):
    monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=flag):
        launch_train.main(_one_rank(tmp_path, *flags, "--device", "cpu"))
    assert not dist.is_initialized()


@pytest.mark.parametrize("num,rank,env,want", [
    (2, 1, {}, (2, 1)),
    (None, None, {"WORLD_SIZE": "4", "RANK": "3"}, (4, 3)),
    (2, None, {"WORLD_SIZE": "4", "RANK": "1"}, (2, 1))])
def test_world_and_rank_take_flags_then_environment(num, rank, env, want):
    assert launch_train.world_and_rank(num, rank, env) == want


@pytest.mark.parametrize("num,rank", [(2, 2), (2, -1)])
def test_rank_outside_the_world_raises(num, rank):
    with pytest.raises(ValueError, match="--process-id"):
        launch_train.world_and_rank(num, rank, {})


@pytest.mark.parametrize("device,rank,cards,want", [
    ("cuda", 3, 2, "cuda:1"), ("cuda", 0, 1, "cuda:0"),
    ("cuda", 1, 1, "cuda:0"), ("cuda:0", 3, 2, "cuda:0"),
    ("cpu", 3, 2, "cpu")])
def test_rank_device(device, rank, cards, want):
    got = launch_train.rank_device(torch.device(device), rank, cards)
    assert got == torch.device(want)


def test_cuda_without_a_card_raises_before_any_group(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(_one_rank(tmp_path, "--num-processes", "1",
                                    "--process-id", "0", "--device",
                                    "cuda"))
    assert not dist.is_initialized()


def test_a_card_group_is_nccl_bound_to_the_ranks_card(tmp_path,
                                                      monkeypatch):
    calls = []

    class Stop(Exception):
        pass

    def init(backend, **kw):
        calls.append(("init", backend, kw))
        raise Stop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", d)))
    monkeypatch.setattr(dist, "init_process_group", init)
    coordinator = _one_rank(tmp_path, "--num-processes", "4",
                            "--process-id", "3", "--device", "cuda")
    with pytest.raises(Stop):
        launch_train.main(coordinator)
    port = coordinator[coordinator.index("--coordinator") + 1]
    assert calls == [("set_device", torch.device("cuda", 1)),
                     ("init", "nccl", {
                         "init_method": f"tcp://{port}", "world_size": 4,
                         "rank": 3, "device_id": torch.device("cuda", 1)})]
