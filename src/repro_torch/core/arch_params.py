"""PTA architecture parameters (Section III-A of the paper).

The five searchable parameters identified from the coherent optical dataflow:

  N_t      number of tiles per chip
  N_c      number of DPTC cores per tile
  N_h      number of input horizontal waveguides per core (rows of the DDot array)
  N_v      number of input vertical waveguides per core (columns of the DDot array)
  N_lambda number of WDM wavelengths (dot-product length per DDot per cycle)

Global SRAM is *derived* from the workload (largest layer activation + staging
buffers), not searched — see Section III-A observation 2 of the paper.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class PTAConfig:
    """One point in the PTA design space."""

    n_t: int = 4
    n_c: int = 2
    n_h: int = 12
    n_v: int = 12
    n_lambda: int = 12

    def __post_init__(self) -> None:
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v < 1:
                raise ValueError(f"{f.name} must be >= 1, got {v}")

    @property
    def cores(self) -> int:
        return self.n_t * self.n_c

    @property
    def ddots_per_core(self) -> int:
        return self.n_h * self.n_v

    @property
    def macs_per_cycle(self) -> int:
        """Peak MACs per photonic cycle.

        Tiles parallelise the M dimension (Fig. 6: matrix rows to tiles), the
        DDot array covers N_h rows x N_v columns, cores within a tile split the
        contraction (their partial photocurrents accumulate before the shared
        tile ADC array), and each DDot contracts N_lambda wavelengths/cycle.
        """
        return self.n_t * self.n_h * self.n_v * self.n_c * self.n_lambda

    def as_array(self) -> np.ndarray:
        return np.array([self.n_t, self.n_c, self.n_h, self.n_v, self.n_lambda],
                        dtype=np.int64)

    @staticmethod
    def from_array(a) -> "PTAConfig":
        a = np.asarray(a).astype(int)
        return PTAConfig(int(a[0]), int(a[1]), int(a[2]), int(a[3]), int(a[4]))

    def __str__(self) -> str:  # compact, used in benchmark tables
        return (f"Nt={self.n_t} Nc={self.n_c} Nh={self.n_h} "
                f"Nv={self.n_v} Nl={self.n_lambda}")


# State-of-the-art reference designs (Lightening-Transformer, HPCA'24), as
# characterised by the DxPTA paper's case study: LT-Base (N_t=4, N_c=2) at
# ~60 mm^2 / ~15 W and LT-Large at ~112 mm^2 / ~28 W.
LT_BASE = PTAConfig(n_t=4, n_c=2, n_h=12, n_v=12, n_lambda=12)
LT_LARGE = PTAConfig(n_t=8, n_c=2, n_h=12, n_v=12, n_lambda=12)

# Alg. 1 default values used while sweeping one parameter at a time.
ALG1_DEFAULTS = PTAConfig(n_t=4, n_c=2, n_h=12, n_v=12, n_lambda=12)


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Application constraints (Section IV): defaults are the paper's.

    Every bound must be a positive number; +inf means "unconstrained" on
    that axis (pareto_front builds such relaxations). NaN and non-positive
    bounds are rejected at construction — a NaN bound makes every
    feasibility comparison silently False, which is indistinguishable
    from a genuinely infeasible search.
    """

    area_mm2: float = 50.0
    power_w: float = 5.0
    energy_mj: float = 50.0
    latency_ms: float = 10.0

    def __post_init__(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, (int, float, np.integer, np.floating)) \
                    or isinstance(v, bool) or v != v or v <= 0:
                raise ValueError(
                    f"constraint bound {f.name}={v!r} must be a positive "
                    f"number (+inf = unconstrained)")

    @property
    def energy_j(self) -> float:
        return self.energy_mj * 1e-3

    @property
    def latency_s(self) -> float:
        return self.latency_ms * 1e-3

    def satisfied(self, area_mm2, power_w, energy_j, latency_s):
        """Elementwise feasibility test (SI units); scalars or arrays."""
        return ((area_mm2 < self.area_mm2) & (power_w < self.power_w)
                & (energy_j < self.energy_j) & (latency_s < self.latency_s))


PAPER_CONSTRAINTS = Constraints()


def config_grid(t_cnd, c_cnd, v_cnd, h_cnd, g_cnd) -> np.ndarray:
    """Dense (G, 5) int array of every combination of the candidate sets."""
    grids = np.meshgrid(np.asarray(t_cnd), np.asarray(c_cnd), np.asarray(v_cnd),
                        np.asarray(h_cnd), np.asarray(g_cnd), indexing="ij")
    # Column order follows PTAConfig: (n_t, n_c, n_h, n_v, n_lambda). The
    # paper's candidate-set naming is T, C, V, H, G — note V=n_v, H=n_h.
    cols = [grids[0], grids[1], grids[3], grids[2], grids[4]]
    return np.stack([g.reshape(-1) for g in cols], axis=1).astype(np.int64)


def iter_configs(grid: np.ndarray) -> Iterator[PTAConfig]:
    for row in grid:
        yield PTAConfig.from_array(row)
