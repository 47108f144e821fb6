"""Component-level area/power model of the LT-style PTA (eval_hw in Alg. 2).

The port's copy of `repro.core.photonic_model`: the same constants, the same
component breakdowns in the same dict order, the same float64 host
arithmetic. Every function here is plain arithmetic over its arguments, so
it takes Python scalars, numpy arrays or torch tensors alike; the torch
float32 hierarchical prefilter (`core.search.hw_prefilter_masks`) replays
the breakdowns on device tensors and relies on that dict order.

Architecture accounting (per the coherent optical dataflow, Sec. III-A):

  core  = N_h*N_v DDots, the per-core MZM operand modulators + DACs
          ((N_h+N_v)*N_lambda channels) and the accumulator lanes.
  tile  = N_c cores + the shared tile-level ADC/TIA array, frequency-comb
          laser (N_lambda lines), control.
  chip  = N_t tiles + inter-tile optical broadcast network (~Nt^2),
          derived global SRAM, off-chip interface + global control.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DeviceConstants:
    # --- clock ---
    f_clk_hz: float = 10e9         # photonic compute / conversion clock

    # --- per-device area (mm^2) ---
    a_mzm: float = 0.0095          # high-speed Mach-Zehnder modulator
    a_dac: float = 0.0038          # 4-bit multi-GS/s DAC channel
    a_ddot: float = 0.0040         # DC + phase shifter + 2 balanced PDs
    a_acc: float = 0.0010          # analog accumulator lane per DDot output
    a_core_fixed: float = 0.05
    a_adc: float = 0.0052          # 4-bit ADC (tile-shared array)
    a_tia: float = 0.0008
    a_comb_base: float = 0.25      # frequency comb laser + mux
    a_comb_per_lambda: float = 0.02
    a_tile_fixed: float = 0.45     # tile control, clocking, local routing
    a_inter_tile_net: float = 0.30  # * Nt^2 — global optical broadcast network
    a_sram_per_mb: float = 0.55
    a_chip_fixed: float = 5.60     # off-chip PHY, global control, I/O ring

    # --- per-device power (W) ---
    p_mzm: float = 1.5e-3          # modulator driver @ 4b/5GHz
    p_dac: float = 2.3e-3
    p_pd: float = 0.3e-3           # per photodiode (2 per DDot)
    p_acc: float = 0.4e-3
    p_core_fixed: float = 0.010
    p_adc: float = 1.45e-3
    p_tia: float = 0.15e-3
    p_comb_base: float = 0.020
    p_comb_per_lambda: float = 0.001
    p_laser_split: float = 2.0e-5  # * N_lambda*N_h*N_v — optical power budget
    p_tile_fixed: float = 0.005
    p_inter_tile_net: float = 0.09  # * Nt^2 — clock/serdes + thermal tuning
    p_sram_per_mb: float = 0.090   # leakage + refresh-equivalent static
    p_chip_fixed: float = 1.66     # DRAM PHY, global control

    # --- energy (J) per event, for eval_wload ---
    e_dram_per_byte: float = 16e-12
    e_sram_per_byte: float = 0.8e-12

    # --- memory system ---
    dram_bw_bytes: float = 64e9    # off-chip bandwidth
    sram_min_mb: float = 4.0
    sram_max_mb: float = 64.0

    # --- electronic unit (softmax / LN / GELU / residual / scan) ---
    elec_ops_per_s: float = 5e11   # elementwise-op throughput
    p_elec: float = 0.15           # active power of the electronic unit

    # --- operand precision (LT is a 4-bit design) ---
    act_bits: int = 4
    weight_bits: int = 4

    def __post_init__(self):
        # A nonsense constant (NaN, zero, negative) silently yields garbage
        # metrics or a garbage feasibility mask: refuse at construction.
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, bool) or not isinstance(
                    v, (int, float, np.integer, np.floating)):
                raise ValueError(
                    f"DeviceConstants.{f.name} must be a number, got {v!r}")
            if v != v or not np.isfinite(v):
                raise ValueError(
                    f"DeviceConstants.{f.name} is non-finite ({v!r})")
            if v <= 0:
                raise ValueError(
                    f"DeviceConstants.{f.name} must be > 0, got {v!r}")
        if self.sram_min_mb > self.sram_max_mb:
            raise ValueError(
                f"DeviceConstants.sram_min_mb ({self.sram_min_mb!r}) must "
                f"not exceed sram_max_mb ({self.sram_max_mb!r})")


CONSTANTS = DeviceConstants()

DEFAULT_SRAM_MB = 8.0  # used by eval_hw when no workload is attached (Alg. 1)


def sram_mb_for_workload(max_act_bytes: float,
                         c: DeviceConstants = CONSTANTS) -> float:
    """Derived global SRAM size (Sec. III-A observation 2): double-buffered
    largest layer activation plus an off-chip staging region, clipped to
    practical bounds."""
    mb = 2.0 * max_act_bytes / 2**20 + 2.0
    return float(np.clip(mb, c.sram_min_mb, c.sram_max_mb))


def _counts(n_t, n_c, n_h, n_v, n_l):
    cores = n_t * n_c
    mod_channels = cores * (n_h + n_v) * n_l   # MZM+DAC channels (per core)
    ddots = cores * n_h * n_v
    adc_chains = n_t * n_h * n_v               # shared per tile
    return cores, mod_channels, ddots, adc_chains


def area_breakdown(n_t, n_c, n_h, n_v, n_l, sram_mb=DEFAULT_SRAM_MB,
                   c: DeviceConstants = CONSTANTS):
    """Per-component chip area in mm^2 (broadcastable arrays or scalars)."""
    cores, mod_channels, ddots, adc_chains = _counts(n_t, n_c, n_h, n_v, n_l)
    return {
        "mzm": mod_channels * c.a_mzm,
        "dac": mod_channels * c.a_dac,
        "core_optics": ddots * c.a_ddot + ddots * c.a_acc + cores * c.a_core_fixed,
        "adc": adc_chains * (c.a_adc + c.a_tia),
        "laser_comb": n_t * (c.a_comb_base + c.a_comb_per_lambda * n_l),
        "tile_misc": n_t * c.a_tile_fixed,
        "optical_network": c.a_inter_tile_net * n_t * n_t,
        "memory": sram_mb * c.a_sram_per_mb,
        "chip_misc": c.a_chip_fixed + 0.0 * n_t,  # broadcast helper
    }


def power_breakdown(n_t, n_c, n_h, n_v, n_l, sram_mb=DEFAULT_SRAM_MB,
                    c: DeviceConstants = CONSTANTS):
    """Per-component chip power in W (peak active)."""
    cores, mod_channels, ddots, adc_chains = _counts(n_t, n_c, n_h, n_v, n_l)
    laser = n_t * (c.p_comb_base + c.p_comb_per_lambda * n_l) \
        + n_t * c.p_laser_split * n_l * n_h * n_v
    return {
        "mzm": mod_channels * c.p_mzm,
        "dac": mod_channels * c.p_dac,
        "pd": ddots * 2 * c.p_pd,
        "adc": adc_chains * (c.p_adc + c.p_tia),
        "accum": ddots * c.p_acc + cores * c.p_core_fixed,
        "laser": laser,
        "tile_misc": n_t * c.p_tile_fixed,
        "network_clock": c.p_inter_tile_net * n_t * n_t,
        "memory": sram_mb * c.p_sram_per_mb,
        "chip_misc": c.p_chip_fixed + 0.0 * n_t,
    }


def eval_hw(n_t, n_c, n_h, n_v, n_l, sram_mb=DEFAULT_SRAM_MB,
            c: DeviceConstants = CONSTANTS):
    """Alg. 2 line 11: (area_mm2, power_w) for config(s); vectorized over
    array arguments."""
    area = sum(area_breakdown(n_t, n_c, n_h, n_v, n_l, sram_mb, c).values())
    power = sum(power_breakdown(n_t, n_c, n_h, n_v, n_l, sram_mb, c).values())
    return area, power


def eval_hw_config(cfg, sram_mb=DEFAULT_SRAM_MB,
                   c: DeviceConstants = CONSTANTS):
    """Scalar convenience wrapper over a PTAConfig."""
    return eval_hw(cfg.n_t, cfg.n_c, cfg.n_h, cfg.n_v, cfg.n_lambda, sram_mb,
                   c)
