"""Model zoo facade (the port of `repro.models`): dispatch on cfg.family.

Only the dense and vlm families are ported; the others raise
NotImplementedError (ROADMAP Queue 1 item 14). Parameters are a
`lm.DecoderLM` module; entry points run on "cuda" unless the caller names
another device.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._device import resolve_device
from ..configs.base import ModelConfig
from . import lm
from .layers import DTYPE


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> lm.DecoderLM:
    """Random parameters on `device` ("cuda" by default), drawn from
    `generator` (default: a generator on that device seeded with 0). The
    draws are not `jax.random`'s: parity tests carry the reference's
    weights across (`interop.lm_params_from_reference`)."""
    lm.require_ported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: torch draws on the generator's device")
    return lm.init_params(cfg, generator, dev)


def prefill(params: lm.DecoderLM, cfg: ModelConfig, batch):
    return lm.prefill(params, cfg, batch)


def decode_step(params: lm.DecoderLM, cfg: ModelConfig, tokens, pos, cache):
    return lm.decode_step(params, cfg, tokens, pos, cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return lm.init_cache(cfg, batch, max_len, resolve_device(device))


__all__ = ["DTYPE", "decode_step", "init_cache", "init_params", "prefill"]
