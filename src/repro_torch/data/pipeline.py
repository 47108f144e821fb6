"""Deterministic synthetic data pipeline (the port of
`repro/data/pipeline.py`): token streams + stub modality embeddings,
checkpointable.

Batches are numpy arrays drawn from `np.random.default_rng((seed, step))`,
the reference's draws, so the two packages see the same batch at every
step, bit for bit; a trainer moves them to its device. The pipeline is
stateful by step index only: resuming from a checkpoint replays nothing
and skips nothing (the step index is part of the checkpoint's extra).
`shard_batch` lays a host batch out as DTensors on a mesh (the reference's
device_put with per-input shardings).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from ..configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass
class PipelineState:
    step: int = 0
    seed: int = 0


class SyntheticTokenSource:
    """Counter-based (stateless-random) batch generator: the batch at step N
    is a pure function of (seed, N) — no RNG state to checkpoint."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 zipf_a: float = 1.2):
        self.cfg = cfg
        self.shape = shape
        self.state = PipelineState(step=0, seed=seed)
        self.zipf_a = zipf_a

    def _tokens(self, rng: np.random.Generator, b: int, s: int) -> np.ndarray:
        # Zipf-distributed ids folded into the vocab: realistic
        # embedding-gather locality, unlike uniform ids.
        z = rng.zipf(self.zipf_a, size=(b, s))
        return (z % self.cfg.vocab).astype(np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg, sh = self.cfg, self.shape
        rng = np.random.default_rng((self.state.seed, step))
        b, s = sh.global_batch, sh.seq_len
        out: Dict[str, np.ndarray] = {}
        if cfg.family == "encdec":
            s_src = s // 2
            out["src_embeds"] = rng.standard_normal(
                (b, s_src, cfg.d_model), dtype=np.float32)
            out["tokens"] = self._tokens(rng, b, s - s_src)
        elif cfg.family == "vlm":
            p = cfg.n_prefix_embeds
            out["embeds"] = rng.standard_normal(
                (b, p, cfg.d_model), dtype=np.float32)
            out["tokens"] = self._tokens(rng, b, s - p)
        else:
            out["tokens"] = self._tokens(rng, b, s)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            batch = self.batch_at(self.state.step)
            self.state.step += 1
            yield batch

    # ---- checkpoint integration ----
    def state_dict(self) -> Dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: Dict) -> None:
        self.state = PipelineState(**d)


def shard_batch(batch: Dict[str, np.ndarray], placements_by_key, mesh) -> Dict:
    """A host batch as DTensors on `mesh`: each array distributed with its
    key's placements (`placements_by_key` a dict by key, or one placements
    tuple for every key; `parallel.sharding.placements` turns a spec into
    one)."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    out = {}
    for k, v in batch.items():
        pl = placements_by_key[k] if isinstance(placements_by_key, dict) \
            else placements_by_key
        out[k] = distribute_tensor(torch.from_numpy(np.ascontiguousarray(v)),
                                   mesh, pl)
    return out
