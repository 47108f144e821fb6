"""Alg. 1 — parameter-significance analysis (Sec. III-B).

For each parameter, sweep its value j = 1..J while holding the others at the
Alg. 1 defaults (Nt=4, Nc=2, Nv=Nh=Nl=12), evaluate area/power, and score

    S = (1/K) * sum_i  m_{i+1 units} / m_{i units}        (Eq. 5)

i.e. the mean multiplicative impact of adding one unit. High-S parameters
(N_t, N_c) are explored finely by Alg. 2; low-S parameters (N_v, N_h,
N_lambda) get coarse progressive candidate sets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .arch_params import ALG1_DEFAULTS, PTAConfig
from .photonic_model import CONSTANTS, DEFAULT_SRAM_MB, DeviceConstants, eval_hw

PARAM_NAMES = ("n_t", "n_c", "n_h", "n_v", "n_lambda")


@dataclasses.dataclass(frozen=True)
class SignificanceScore:
    s_area: float
    s_power: float


def observe_significance(j_max: int = 10,
                         defaults: PTAConfig = ALG1_DEFAULTS,
                         c: DeviceConstants = CONSTANTS,
                         sram_mb: float = DEFAULT_SRAM_MB,
                         ) -> Dict[str, SignificanceScore]:
    """Alg. 1. Returns {param_name: SignificanceScore}.

    Vectorized across the J observations (the paper's pseudocode loops; the
    math is identical — ratios of consecutive area/power values).
    """
    scores: Dict[str, SignificanceScore] = {}
    base = {f: getattr(defaults, f) for f in PARAM_NAMES}
    js = np.arange(1, j_max + 1)
    for name in PARAM_NAMES:
        vals = {k: np.full_like(js, v) for k, v in base.items()}
        vals[name] = js
        area, power = eval_hw(vals["n_t"], vals["n_c"], vals["n_h"],
                              vals["n_v"], vals["n_lambda"], sram_mb, c)
        s_a = float(np.mean(area[1:] / area[:-1]))
        s_p = float(np.mean(power[1:] / power[:-1]))
        scores[name] = SignificanceScore(s_area=s_a, s_power=s_p)
    return scores


def significant_params(scores: Dict[str, SignificanceScore],
                       top_k: int = 2) -> tuple:
    """Parameters ranked most significant (by combined area+power score)."""
    ranked = sorted(scores, key=lambda n: -(scores[n].s_area
                                            + scores[n].s_power))
    return tuple(ranked[:top_k])


def refinement_sets(scores: Dict[str, SignificanceScore],
                    front_rows: np.ndarray, n_z: int, top_k: int = 2,
                    radius: int = 1) -> Dict[str, list]:
    """Per-parameter candidate sets for a second, finer pass around a coarse
    frontier (the Alg. 1 -> Alg. 2 coupling applied to frontier search).

    The top-k significant parameters get a dense +/-`radius` neighborhood of
    every value the coarse frontier visits (clipped to 1..n_z); the
    non-significant parameters keep exactly their frontier values — their
    coarse progressive step already captured their (weak) impact, so
    re-gridding them would only inflate the fine pass. Vectorized over the
    frontier rows; `front_rows` columns follow PTAConfig order.
    """
    fine = set(significant_params(scores, top_k=top_k))
    front = np.asarray(front_rows).reshape(-1, len(PARAM_NAMES))
    offsets = np.arange(-radius, radius + 1)
    sets: Dict[str, list] = {}
    for j, name in enumerate(PARAM_NAMES):
        vals = np.unique(front[:, j])
        if name in fine:
            vals = np.unique(np.clip(vals[:, None] + offsets[None, :],
                                     1, n_z))
        sets[name] = [int(v) for v in vals]
    return sets
