"""The port's training entry points on the CPU at tiny sizes: one gradient
step of every arch (`tests/test_archs_smoke.py`'s `test_train_gradient_step`
on the port), the train and eval steps, `launch.train` and
`examples/train_photonic_qat_torch.py`. No tolerance: the checks are
finiteness, shapes, counts and equalities.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import repro_torch.models as M
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticTokenSource
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw
from repro_torch.train.trainer import (batch_to, make_eval_step,
                                       make_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def make_batch(cfg, b=2, s=16, seed=1):
    """`tests/test_archs_smoke.py`'s batch shapes, drawn with numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, 8, cfg.d_model)).astype(np.float32))
    return batch


def test_all_ten_archs_present():
    assert len(list_archs()) == 10


@pytest.mark.parametrize("name", list_archs())
def test_train_gradient_step(name):
    cfg = reduced(get_config(name))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model.requires_grad_(True)
    loss, _ = M.lm_loss(model, cfg, make_batch(cfg))
    loss.backward()
    assert torch.isfinite(loss)
    grads = [p.grad for p in model.parameters()]
    assert all(g is None or not bool(torch.isnan(g).any()) for g in grads)
    # gradient signal almost everywhere (the aux-free route bias steers
    # the top-k only and gets none, as in the reference)
    nz = sum(g is not None and float(g.float().abs().sum()) > 0
             for g in grads)
    assert nz > len(grads) // 2


@pytest.mark.parametrize("name", ["qwen2.5-3b", "deepseek-v3-671b",
                                  "seamless-m4t-medium"])
def test_train_step_updates_in_place_and_eval_step_agrees(name):
    cfg = reduced(get_config(name))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=4)
    state = adamw.init(opt_cfg, dict(model.named_parameters()))
    src = SyntheticTokenSource(cfg, ShapeConfig("tiny", 16, 2, "train"))
    batch = batch_to(src.batch_at(0), "cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ev = make_eval_step(cfg)(model, batch)["loss"]
    step = make_train_step(cfg, opt_cfg)
    out, state, metrics = step(model, state, batch)
    assert out is model and int(state.step) == 1
    assert float(metrics["loss"]) == float(ev)     # same forward
    assert float(metrics["lr"]) > 0 and float(metrics["grad_norm"]) > 0
    assert all(p.grad is None for p in model.parameters())
    moved = sum(not torch.equal(before[n], p)
                for n, p in model.named_parameters())
    assert moved > len(before) // 2
    assert float(make_eval_step(cfg)(model, batch)["loss"]) < float(ev)


def test_training_after_serving_in_the_same_process():
    # The models' cached f32 constants (`layers._f32`) made first under
    # `torch.inference_mode()` (as `Server` runs) must still serve a
    # backward pass afterwards.
    from repro_torch.models.layers import _f32
    cfg = reduced(get_config("qwen2.5-3b"))
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg)
    _f32.cache_clear()
    with torch.inference_mode():
        M.prefill(model, cfg, batch)
    model.requires_grad_(True)
    loss, _ = M.lm_loss(model, cfg, batch)
    loss.backward()
    assert torch.isfinite(loss)
    assert all(p.grad is not None for p in model.parameters())


def test_launch_train_on_the_cpu(tmp_path, capsys):
    out = launch_train.main(["--arch", "granite-3-2b", "--reduced",
                             "--steps", "3", "--ckpt-every", "2",
                             "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    assert "done: step 3" in capsys.readouterr().out
    # a rerun resumes from the last checkpoint and trains 3 steps more
    again = launch_train.main(["--arch", "granite-3-2b", "--reduced",
                               "--steps", "3", "--ckpt-dir", str(tmp_path),
                               "--device", "cpu"])
    assert again["final_step"] == 6


def _example():
    path = ROOT / "examples" / "train_photonic_qat_torch.py"
    spec = importlib.util.spec_from_file_location("train_qat_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_trains_on_the_cpu(tmp_path, capsys):
    out = _example().main(["--steps", "12", "--d-model", "64", "--layers",
                           "2", "--seq", "32", "--batch", "4",
                           "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert out["final_step"] == 12
    assert out["losses"][-1] < out["losses"][0]
    assert "loss" in capsys.readouterr().out


def test_example_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example().main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
