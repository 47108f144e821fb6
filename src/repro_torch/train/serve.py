"""Serving loop (the port of `repro/train/serve.py`): batched greedy decoding
with prefill + decode_step, plus the photonic-execution report.

`Server` pads requests into a fixed batch and decodes greedily, for every
decoder family (the batch holds tokens only, as in the reference, so the
enc-dec family, whose prefill needs `src_embeds`, fails with the
reference's KeyError and runs through `models.prefill`/`decode_step`);
`photonic_report` attaches the DxPTA cost-model estimate (energy/latency on
the searched PTA config) of the same serving workload — the co-design
loop's serving-side output.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import models
from .._device import resolve_device
from ..configs.base import ModelConfig


@dataclasses.dataclass
class Request:
    prompt: np.ndarray          # (S,) int32
    max_new: int = 16
    out: Optional[List[int]] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """Batched greedy decoding. Requests are left-padded with token 0 into
    a fixed batch (the padded positions are not masked, as in the
    reference); positions are 0..plen-1; the first token is the argmax of
    the prefill logits (the first index wins ties) and decode step j runs
    at position plen + j against a cache grown to `max_len`.

    `device` is where the batch runs ("cuda" unless the caller names
    another); `params` must already lie there."""

    def __init__(self, cfg: ModelConfig, params, batch_size: int,
                 max_len: int, device=None):
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.max_len = max_len
        self.device = device

    def generate(self, requests: List[Request]) -> Dict:
        """Fills each request's `out`; returns {"ttft_s", "decode_s_per_tok",
        "tokens"}, host-clock times of work that ends in a device sync."""
        dev = resolve_device(self.device)
        if self.params.device.type != dev.type:
            raise ValueError(f"parameters lie on {self.params.device}, the "
                             f"server runs on {dev}")
        assert len(requests) <= self.batch_size
        b = self.batch_size
        plen = max(len(r.prompt) for r in requests)
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(requests):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        with torch.inference_mode():
            batch = {"tokens": torch.from_numpy(toks).to(self.params.device)}
            _sync(dev)
            t0 = time.perf_counter()
            logits, cache = models.prefill(self.params, self.cfg, batch)
            cache = _grow_cache(cache, self.max_len)
            _sync(dev)
            ttft = time.perf_counter() - t0

            max_new = max(r.max_new for r in requests)
            outs = [[] for _ in range(b)]
            tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            step_times = []
            for j in range(max_new):
                host = tok[:, 0].tolist()
                for i in range(len(requests)):
                    outs[i].append(int(host[i]))
                t1 = time.perf_counter()
                logits, cache = models.decode_step(self.params, self.cfg,
                                                   tok, plen + j, cache)
                _sync(dev)
                step_times.append(time.perf_counter() - t1)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        for r, o in zip(requests, outs):
            r.out = o[:r.max_new]
        return {"ttft_s": ttft, "decode_s_per_tok": float(np.mean(step_times)),
                "tokens": sum(r.max_new for r in requests)}


def _grow_cache(cache, max_len: int):
    """Zero-pad attention caches' sequence axis (axis 2) up to max_len: the
    K/V rows ("k", "v") and MLA's latent rows ("c", "rope"); recurrent
    states and the enc-dec cross K/V keep their shapes."""
    def pad(k, x):
        if k in ("k", "v", "c", "rope") and x.ndim >= 3 \
                and x.shape[2] < max_len:
            grown = x.new_zeros(x.shape[:2] + (max_len,) + x.shape[3:])
            grown[:, :, :x.shape[2]] = x
            return grown
        return x
    return {k: pad(k, v) for k, v in cache.items()}


def photonic_report(cfg: ModelConfig, seq_len: int, batch: int,
                    new_tokens: int, device=None):
    """DxPTA co-design hook: search a PTA for this serving workload (the
    paper-faithful `python` engine, as the reference) and report the
    photonic-execution estimate."""
    from ..core import Constraints, dxpta_search
    from ..core.extract import serving_workload

    wl = serving_workload(cfg, seq_len=seq_len, batch=batch,
                          new_tokens=new_tokens)
    # decode restreams the active weights every step -> budget per token
    # (the paper's 50 mJ / 10 ms budgets are whole-batch inference budgets)
    cons = Constraints(energy_mj=10.0 * new_tokens,
                       latency_ms=30.0 * new_tokens)
    r = dxpta_search(wl, cons, device=device)
    note = "within paper-style budget"
    if not r.feasible:
        # LLM decode is weight-streaming bound; report the min-EDP design
        # inside the area/power box and let the caller see the honest cost.
        r = dxpta_search(wl, Constraints(energy_mj=1e9, latency_ms=1e9),
                         device=device)
        note = "energy/latency budget exceeded; min-EDP within 50mm2/5W"
    return {"workload": wl.name, "feasible": r.feasible, "note": note,
            "pta_config": str(r.best_cfg) if r.feasible else None,
            "area_mm2": r.area_mm2, "power_w": r.power_w,
            "energy_mj": r.energy_j * 1e3, "latency_ms": r.latency_s * 1e3}
