"""Latency/energy model of a workload on a PTA config (eval_wload in Alg. 2).

The port of `repro.core.performance_model`. On the host (numpy) the
ceil-divisions run in int64, every float product in float64, in the
reference's order, so the float64 results are bit-identical to it. The
torch engine's float32 form, `eval_wload_tensors`, is the reference's
`eval_wload_arrays(..., xp=jnp)`: int32 ceil-divisions, float32 products
and sums in the same order, on the tensors' device. The kernels' float32
form lives in `kernels/dse_eval.py` (the CUDA kernels and their plain
PyTorch versions).

  cycles  = ceil(M / (N_t*N_h)) * ceil(N / N_v) * ceil(K / (N_c*N_lambda))
  latency = max(photonic GEMM time, off-chip streaming time) + electronic time
  energy  = chip power x latency + DRAM traffic + SRAM operand traffic
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .photonic_model import CONSTANTS, DeviceConstants, eval_hw, sram_mb_for_workload
from .workload import Workload


def _ceil_div(a, b):
    return (a + b - 1) // b


#: Largest GEMM dimension the int32 device formulation handles exactly:
#: the kernels' `a + b - 1` needs headroom for the divisor product b
#: (config-parameter products are <= 4096 in practice).
I32_DIM_LIMIT = 2**31 - 4096


def require_i32_dims(gemm_array, where: str = "device engine") -> None:
    """Reject GEMM dims the int32 device kernels would wrap.

    The CUDA kernels (like the Pallas kernels they replace) run the
    ceil-divisions in int32, so a dim at or above `I32_DIM_LIMIT` would
    silently wrap negative. The host (numpy) paths compute in int64 and
    have no such ceiling.
    """
    g = np.asarray(gemm_array)
    dims = g[:, :3] if g.ndim == 2 else g
    if dims.size and int(dims.max()) > I32_DIM_LIMIT:
        w, ax = np.unravel_index(int(dims.argmax()), dims.shape)
        raise ValueError(
            f"GEMM dim {'MKN'[ax]}={int(dims[w, ax])} (gemm row {w}) "
            f"exceeds the int32 cycle-count limit {I32_DIM_LIMIT} of the "
            f"{where}; use the numpy engine (int64 host path) or split "
            f"the workload (e.g. smaller batch x seq product)")


def gemm_cycles(m, k, n, n_t, n_c, n_h, n_v, n_l):
    """Photonic cycles for one GEMM on one config (broadcastable numpy).

    The three ceil-divisions run in int64 (exact for any serving-scale
    dim); the terms become float64 only for the cycle product.
    """
    m, k, n = (np.asarray(v).astype(np.int64) for v in (m, k, n))
    d_m = np.asarray(n_t * n_h).astype(np.int64)
    d_n = np.asarray(n_v).astype(np.int64)
    d_k = np.asarray(n_c * n_l).astype(np.int64)
    return ((_ceil_div(m, d_m) * 1.0)
            * (_ceil_div(n, d_n) * 1.0)
            * (_ceil_div(k, d_k) * 1.0))


def cycle_factor_tables(gemm_array, m_divs, n_divs, k_divs):
    """Per-GEMM axis tables of gemm_cycles' three ceil-division factors.

    Returns (f_m, f_n, f_k) int64 tables of shape (W, len(divs)) with
    f_m[w, i] = ceil(M_w / m_divs[i]) etc. — bit-for-bit the factors
    `gemm_cycles` computes per config.
    """
    g = np.asarray(gemm_array)
    m, k, n = (g[:, i].astype(np.int64) for i in (0, 1, 2))

    def table(dim, divs):
        d = np.asarray(divs).astype(np.int64)
        return _ceil_div(dim[:, None], d[None, :])

    return table(m, m_divs), table(n, n_divs), table(k, k_divs)


def eval_wload_arrays(n_t, n_c, n_h, n_v, n_l, gemm_array, elec_ops,
                      weight_bytes, act_io_bytes, sram_mb,
                      c: DeviceConstants = CONSTANTS):
    """(energy_J, latency_s, utilization) for config grid x one workload.

    n_t..n_l: scalars or (G,) arrays; gemm_array: (W, 4) [M, K, N, count].
    """
    n_t, n_c, n_h, n_v, n_l = (np.asarray(a)[..., None] for a in
                               (n_t, n_c, n_h, n_v, n_l))  # (G, 1)
    g = np.asarray(gemm_array)
    m, k, n = g[:, 0], g[:, 1], g[:, 2]                      # (W,)
    count = g[:, 3] * 1.0

    cyc = gemm_cycles(m, k, n, n_t, n_c, n_h, n_v, n_l) * count  # (G, W)
    total_cycles = np.sum(cyc, axis=-1)                           # (G,)
    macs = np.sum((m * 1.0) * (k * 1.0) * (n * 1.0) * count)
    peak_macs = (n_t * n_h * n_v * n_c * n_l)[..., 0]
    util = macs / np.maximum(total_cycles * peak_macs, 1.0)

    t_photonic = total_cycles / c.f_clk_hz
    t_mem = (weight_bytes + act_io_bytes) / c.dram_bw_bytes
    t_elec = elec_ops / c.elec_ops_per_s
    latency = np.maximum(t_photonic, t_mem) + t_elec

    _, power = eval_hw(n_t[..., 0], n_c[..., 0], n_h[..., 0], n_v[..., 0],
                       n_l[..., 0], sram_mb, c)
    # SRAM operand streaming: X rows (N_t*N_h lanes) + Y cols (N_v lanes),
    # each N_c*N_lambda values deep, every cycle, at act_bits precision.
    lanes = (n_t * n_h + n_v) * n_c * n_l
    sram_bytes = np.sum(cyc * lanes, axis=-1) * c.act_bits / 8.0
    energy = (power * latency
              + c.e_dram_per_byte * (weight_bytes + act_io_bytes)
              + c.e_sram_per_byte * sram_bytes)
    return energy, latency, util


# ---------------------------------------------------------------------------
# The float32 model on torch tensors (the torch engine). The reference's jax
# engine runs `eval_wload_arrays` / `eval_hw` with xp=jnp and x64 off:
# int32 ceil-divisions, float32 everywhere else, Python-float constants
# folded in float64 and rounded once where they meet an array (JAX's weak
# typing; a torch op with a Python scalar rounds it the same way). Two
# things differ from a literal translation: a sum over the GEMM axis adds
# one GEMM at a time from zero, as XLA's reduce does (`torch.sum`
# reassociates), and every division takes a tensor divisor (PyTorch's CUDA
# division by a Python scalar multiplies by its reciprocal, and
# `scalar / tensor` does too on every device).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def gemm_tensor(gemms: tuple, device: torch.device) -> torch.Tensor:
    """(W, 4) int32 [m, k, n, count] of a `workload_statics` GEMM list on
    `device`, as the jax engine bakes it (int64, narrowed to int32)."""
    return torch.from_numpy(
        np.asarray(gemms, np.int64).astype(np.int32)).to(device)


def scalar_tensor(x, device) -> torch.Tensor:
    """A float32 0-d tensor of x on `device` (a divisor, or a bound)."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def gemm_sum(terms: torch.Tensor) -> torch.Tensor:
    """Sum over the last (GEMM) axis, one term at a time from zero."""
    total = torch.zeros(terms.shape[:-1], dtype=terms.dtype,
                        device=terms.device)
    for w in range(terms.shape[-1]):
        total = total + terms[..., w]
    return total


def workload_tail_tensors(cols, cyc, power, gemm_t, elec_ops, weight_bytes,
                          act_io_bytes, c: DeviceConstants = CONSTANTS):
    """(energy, latency, util) from config columns, per-GEMM cycles (GEMM
    axis last, broadcasting against the columns) and chip power: the
    float32 tail that `eval_wload_arrays` and `factorized.evaluate_space`
    share."""
    n_t, n_c, n_h, n_v, n_l = cols
    dev = cyc.device
    m, k, n = (gemm_t[:, i] * 1.0 for i in range(3))
    count = gemm_t[:, 3] * 1.0
    total_cycles = gemm_sum(cyc)
    macs = gemm_sum(m * k * n * count)
    peak_macs = n_t * n_h * n_v * n_c * n_l
    util = torch.div(macs, torch.maximum(total_cycles * peak_macs,
                                         scalar_tensor(1.0, dev)))
    t_photonic = torch.div(total_cycles, scalar_tensor(c.f_clk_hz, dev))
    t_mem = (weight_bytes + act_io_bytes) / c.dram_bw_bytes
    t_elec = elec_ops / c.elec_ops_per_s
    latency = torch.maximum(t_photonic, scalar_tensor(t_mem, dev)) + t_elec
    lanes = (n_t * n_h + n_v) * n_c * n_l
    sram_bytes = torch.div(gemm_sum(cyc * lanes[..., None]) * c.act_bits,
                           scalar_tensor(8.0, dev))
    energy = (power * latency
              + c.e_dram_per_byte * (weight_bytes + act_io_bytes)
              + c.e_sram_per_byte * sram_bytes)
    return energy, latency, util


def eval_wload_tensors(n_t, n_c, n_h, n_v, n_l, gemm_t, elec_ops,
                       weight_bytes, act_io_bytes, sram_mb,
                       c: DeviceConstants = CONSTANTS):
    """(energy_J, latency_s, utilization) float32 tensors of (G,) float32
    config columns on one device — `eval_wload_arrays` with xp=jnp.

    gemm_t: the (W, 4) int32 `gemm_tensor` on the columns' device; the
    workload scalars are Python floats.
    """
    cols = (n_t, n_c, n_h, n_v, n_l)
    t, c_, h, v, lam = (x[..., None] for x in cols)              # (G, 1)
    m, k, n = gemm_t[:, 0], gemm_t[:, 1], gemm_t[:, 2]           # (W,)
    cm = _ceil_div(m, (t * h).to(torch.int32)) * 1.0
    cn = _ceil_div(n, v.to(torch.int32)) * 1.0
    ck = _ceil_div(k, (c_ * lam).to(torch.int32)) * 1.0
    cyc = cm * cn * ck * (gemm_t[:, 3] * 1.0)                    # (G, W)
    _, power = eval_hw(*cols, sram_mb, c)
    return workload_tail_tensors(cols, cyc, power, gemm_t, elec_ops,
                                 weight_bytes, act_io_bytes, c)


def eval_wload(cfg, wl: Workload, c: DeviceConstants = CONSTANTS):
    """Alg. 2 line 12: (energy_J, latency_s) for one PTAConfig + Workload."""
    sram_mb = sram_mb_for_workload(wl.max_act_bytes, c)
    e, lat, _ = eval_wload_arrays(
        cfg.n_t, cfg.n_c, cfg.n_h, cfg.n_v, cfg.n_lambda, wl.gemm_array,
        wl.elec_ops, wl.weight_bytes, wl.act_io_bytes, sram_mb, c)
    return float(e), float(lat)


def eval_full(cfg, wl: Workload, c: DeviceConstants = CONSTANTS):
    """(area_mm2, power_w, energy_J, latency_s, util) for one config."""
    sram_mb = sram_mb_for_workload(wl.max_act_bytes, c)
    area, power = eval_hw(cfg.n_t, cfg.n_c, cfg.n_h, cfg.n_v, cfg.n_lambda,
                          sram_mb, c)
    e, lat, u = eval_wload_arrays(
        cfg.n_t, cfg.n_c, cfg.n_h, cfg.n_v, cfg.n_lambda, wl.gemm_array,
        wl.elec_ops, wl.weight_bytes, wl.act_io_bytes, sram_mb, c)
    return float(area), float(power), float(e), float(lat), float(u)


def workload_statics(wl: Workload, c: DeviceConstants = CONSTANTS):
    """Hashable (gemms, scalars) tuples describing `wl` for the kernels.

    gemms is ((m, k, n, count), ...) as Python floats; scalars is
    (elec_ops, weight_bytes, act_io_bytes, sram_mb). Every kernel launch
    bakes its workload here, so this is the chokepoint that rejects GEMM
    dims the int32 kernel arithmetic would wrap (`require_i32_dims`).
    """
    require_i32_dims(wl.gemm_array, where="cuda kernel baking")
    gemms = tuple((float(m), float(k), float(n), float(cnt))
                  for m, k, n, cnt in wl.gemm_array)
    scalars = (float(wl.elec_ops), float(wl.weight_bytes),
               float(wl.act_io_bytes),
               float(sram_mb_for_workload(wl.max_act_bytes, c)))
    return gemms, scalars


def calc_edp(energy_j, latency_s):
    """Alg. 2 line 14: energy-delay product (J*s)."""
    return energy_j * latency_s


def fps(wl: Workload, latency_s: float) -> float:
    """Inferences per second (Fig. 11 metric)."""
    return wl.batch / latency_s
