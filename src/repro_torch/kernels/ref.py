"""Float64 numpy oracles for the DSE kernels (the port's copy of the DSE
half of `repro/kernels/ref.py`)."""
from __future__ import annotations

import numpy as np

from ..core.photonic_model import CONSTANTS, DeviceConstants
from ..core.search import evaluate_grid
from ..core.workload import Workload


def dse_eval_ref(grid: np.ndarray, wl: Workload,
                 c: DeviceConstants = CONSTANTS):
    """Oracle for kernels.ops.dse_eval_grid: (G, 4) [area, power, energy,
    latency] via the core (numpy) model, cast to float32."""
    m = evaluate_grid(grid, wl, c)
    return np.stack([m["area"], m["power"], m["energy"], m["latency"]],
                    axis=1).astype(np.float32)


def dse_search_ref(grid: np.ndarray, wl: Workload, constraints,
                   c: DeviceConstants = CONSTANTS):
    """Oracle for kernels.ops.dse_search_grid: (best_idx or -1, n_feasible)
    via the core (numpy, float64) model with the first-hit argmin rule."""
    m = evaluate_grid(grid, wl, c)
    ok = np.asarray(constraints.satisfied(m["area"], m["power"], m["energy"],
                                          m["latency"]))
    n_feasible = int(ok.sum())
    if n_feasible == 0:
        return -1, 0
    edp = np.where(ok, m["edp"], np.inf)
    return int(np.argmin(edp)), n_feasible
