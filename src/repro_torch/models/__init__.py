"""Model zoo facade (the port of `repro.models`): dispatch on cfg.family to
the decoder-LM assembly (`lm.DecoderLM`: dense, vlm, moe, mla_moe,
hybrid_ssm, rwkv) or the enc-dec one (`encdec.EncDec`). Entry points that
build tensors run on "cuda" unless the caller names another device; the
others run where the parameters lie.

Parameters are built with `requires_grad=False` (serving takes no
gradient); a trainer turns them on (`model.requires_grad_(True)`), and
`forward`/`lm_loss` then rematerialise each layer body (`remat=True`, the
reference's default). `rules` (`parallel.sharding.Rules`, None for
`NULL_RULES`) constrains the layouts of DTensor parameters and activations
where the reference's GSPMD constraints sit; on plain tensors every
constraint is the identity. With DTensor parameters each entry point runs
under `parallel.sharding.dtensor_run` (implicit replication of the plain
tensors the models make, and a gather for ops DTensor cannot shard).
"""
from __future__ import annotations

from typing import Optional

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from ..parallel.sharding import NULL_RULES, dtensor_run
from . import encdec, lm
from .layers import DTYPE


def _module(cfg: ModelConfig):
    return encdec if cfg.family == "encdec" else lm


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None):
    """Random parameters on `device` ("cuda" by default), drawn from
    `generator` (default: a generator on that device seeded with 0). The
    draws are not `jax.random`'s: parity tests carry the reference's
    weights across (`interop.params_from_reference`)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: torch draws on the generator's device")
    return _module(cfg).init_params(cfg, generator, dev)


def forward(params, cfg: ModelConfig, batch, rules=None, remat: bool = True):
    with dtensor_run(params, batch):
        return _module(cfg).forward(params, cfg, batch, rules or NULL_RULES,
                                    remat)


def lm_loss(params, cfg: ModelConfig, batch, rules=None, remat: bool = True,
            **kw):
    with dtensor_run(params, batch):
        return _module(cfg).lm_loss(params, cfg, batch, rules or NULL_RULES,
                                    remat, **kw)


def prefill(params, cfg: ModelConfig, batch, rules=None):
    with dtensor_run(params, batch):
        return _module(cfg).prefill(params, cfg, batch, rules or NULL_RULES)


def decode_step(params, cfg: ModelConfig, tokens, pos, cache, rules=None):
    with dtensor_run(params, tokens, cache):
        return _module(cfg).decode_step(params, cfg, tokens, pos, cache,
                                        rules or NULL_RULES)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int = 0,
               device=None):
    dev = resolve_device(device)
    if cfg.family == "encdec":
        return encdec.init_cache(cfg, batch, max_len, src_len, dev)
    return lm.init_cache(cfg, batch, max_len, dev)


__all__ = ["DTYPE", "decode_step", "forward", "init_cache", "init_params",
           "lm_loss", "prefill"]
