// Hopper (sm_90a) kernels of the DxPTA cost model and fused DSE search.
//
// Four kernels replace the four Pallas kernels of
// src/repro/kernels/dse_eval.py that carry the min-EDP co-search:
//
//   dse_eval_kernel           <- dse_eval_padded    (_dse_kernel)
//   dse_search_padded_kernel  <- dse_search_padded  (_dse_search_kernel ->
//                                                    _search_reduce)
//   dse_search_decoded_kernel <- dse_search_decoded (_dse_search_decode_kernel
//                                                    -> _decode_block)
//   dse_decode_rows_kernel    <- dse_decode_rows    (_decode_rows_kernel)
//
// All four share one cost model (hw_metrics: area/power; wl_metrics: the
// per-GEMM dataflow half) and one mixed-radix decoder (decode_lane), as the
// Pallas file shares _config_metrics_hw/_wl and _decode_block.
//
// What bounds them: per config the model is ~55 scalar operations for the
// area/power half and ~18 per GEMM (three int32 ceil-divisions, float32
// products) for the dataflow half. The grid-operand kernels also read 20
// bytes of config (plus 4 of mask) and dse_eval writes 16, which at 3.35
// TB/s outweighs the arithmetic at 67 T op/s: they are bound by bytes.
// dse_decode_rows writes 24 bytes per lane and does little else: bytes.
// dse_search_decoded reads and writes almost nothing: operations. No
// matrix product anywhere, so the tensor cores (wgmma) and TMA have nothing
// to do here. The design keeps it simple: one
// thread per config lane; the GEMM list and the pre-folded constants sit in
// shared memory (one small parameter block per launch); lanes that fail the
// cheap area/power half skip the GEMM loop (exact: feasibility needs both);
// each logical block (2048 lanes, 16384 decoded) is reduced inside one CUDA
// block by warp shuffles into (best EDP, first lane, feasible count).
//
// Float32 parity with the Pallas source: built with -fmad=false (no FMA
// contraction) and IEEE division; every static scalar arrives pre-folded in
// float64 and rounded once to float32 on the host (Python's left-associative
// parse decides which subtrees fold), so the operation order below is the
// Pallas kernel's, op for op.
//
// Every entry point has a plain C interface (loaded with ctypes) and returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 2048;         // lanes per grid-operand block
constexpr int kDecodeBlock = 16384;  // lanes per decoded search block
constexpr int kSearchRows = 3;
constexpr float kCarryIdx = -2.0f;
constexpr int kHeader = 2;           // [W, n_gemms]
constexpr int kConsts = 23;
constexpr int kWlWords = 7;

// Folded constants, in the order of kernels/dse_eval.py:_folded_constants.
enum {
  A_MOD, A_DDOT, A_CORE, A_ADC, A_COMB0, A_COMB1, A_TILE, A_NET, A_CHIP,
  P_MOD, P_PD, P_ADC, P_ACC, P_CORE, P_COMB0, P_COMB1, P_LASER, P_TILE,
  P_NET, P_CHIP, F_CLK, SRAM_SCALE, E_SRAM
};
// Per-workload record: _folded_workload's five floats, then GEMM range.
enum { W_A_SRAM, W_P_SRAM, W_T_MEM, W_T_ELEC, W_E_DRAM, W_G0, W_G1 };

__device__ __forceinline__ float kf(const int* p, int i) {
  return __int_as_float(p[kHeader + i]);
}

__device__ __forceinline__ const int* wl_record(const int* p, int w) {
  return p + kHeader + kConsts + kWlWords * w;
}

__device__ __forceinline__ const int* gemm_record(const int* p, int g) {
  return p + kHeader + kConsts + kWlWords * p[0] + 4 * g;
}

struct Cfg {
  float t, c, h, v, l;
};

// _config_metrics_hw: (area, power) of one config for workload w.
__device__ __forceinline__ void hw_metrics(const int* p, int w, Cfg x,
                                           float& area, float& power) {
  const int* r = wl_record(p, w);
  float cores = x.t * x.c;
  float mod_channels = (cores * (x.h + x.v)) * x.l;
  float ddots = (cores * x.h) * x.v;
  float adc_chains = (x.t * x.h) * x.v;
  float a = mod_channels * kf(p, A_MOD);
  a = a + ddots * kf(p, A_DDOT);
  a = a + cores * kf(p, A_CORE);
  a = a + adc_chains * kf(p, A_ADC);
  a = a + x.t * (kf(p, A_COMB1) * x.l + kf(p, A_COMB0));
  a = a + x.t * kf(p, A_TILE);
  a = a + (kf(p, A_NET) * x.t) * x.t;
  a = a + __int_as_float(r[W_A_SRAM]);
  a = a + kf(p, A_CHIP);
  float q = mod_channels * kf(p, P_MOD);
  q = q + (ddots * 2.0f) * kf(p, P_PD);
  q = q + adc_chains * kf(p, P_ADC);
  q = q + ddots * kf(p, P_ACC);
  q = q + cores * kf(p, P_CORE);
  q = q + x.t * (kf(p, P_COMB1) * x.l + kf(p, P_COMB0));
  q = q + (((x.t * kf(p, P_LASER)) * x.l) * x.h) * x.v;
  q = q + x.t * kf(p, P_TILE);
  q = q + (kf(p, P_NET) * x.t) * x.t;
  q = q + __int_as_float(r[W_P_SRAM]);
  q = q + kf(p, P_CHIP);
  area = a;
  power = q;
}

// _config_metrics_wl: (energy, latency) of one config for workload w.
__device__ __forceinline__ void wl_metrics(const int* p, int w, Cfg x,
                                           float power, float& energy,
                                           float& latency) {
  const int* r = wl_record(p, w);
  float lanes = (((x.t * x.h) + x.v) * x.c) * x.l;
  int d_m = static_cast<int>(x.t * x.h);
  int d_n = static_cast<int>(x.v);
  int d_k = static_cast<int>(x.c * x.l);
  float total = 0.0f;
  float sram_lane = 0.0f;
  for (int g = r[W_G0]; g < r[W_G1]; ++g) {
    const int* q = gemm_record(p, g);  // [m, k, n, count]
    int cm = (q[0] + d_m - 1) / d_m;
    int cn = (q[2] + d_n - 1) / d_n;
    int ck = (q[1] + d_k - 1) / d_k;
    float cyc = ((static_cast<float>(cm) * static_cast<float>(cn))
                 * static_cast<float>(ck)) * __int_as_float(q[3]);
    total = total + cyc;
    sram_lane = sram_lane + cyc * lanes;
  }
  float t_photonic = total / kf(p, F_CLK);
  float lat = fmaxf(t_photonic, __int_as_float(r[W_T_MEM]))
              + __int_as_float(r[W_T_ELEC]);
  float sram_bytes = sram_lane * kf(p, SRAM_SCALE);
  energy = (power * lat + __int_as_float(r[W_E_DRAM]))
           + sram_bytes * kf(p, E_SRAM);
  latency = lat;
}

__device__ __forceinline__ void load_params(const int* __restrict__ params,
                                            int n_words, int* sp) {
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) sp[i] = params[i];
  __syncthreads();
}

// _decode_block for one lane: mixed-radix digits of gidx in meshgrid axis
// order (t, c, v, h, lambda), slab-validity test, clamped per-axis gather.
__device__ __forceinline__ Cfg decode_lane(const float* __restrict__ axes,
                                           int max_radix,
                                           const int* __restrict__ meta,
                                           int r_t, int r_c, int r_v,
                                           int r_h, int r_l, int gidx,
                                           bool& valid) {
  int i = gidx;
  int d_l = i % r_l;
  i = i / r_l;
  int d_h = i % r_h;
  i = i / r_h;
  int d_v = i % r_v;
  i = i / r_v;
  int d_c = i % r_c;
  int d_t = i / r_c;
  valid = gidx < meta[1]
          && d_t >= meta[2] && d_t < meta[3] && d_c >= meta[4] && d_c < meta[5]
          && d_v >= meta[6] && d_v < meta[7] && d_h >= meta[8] && d_h < meta[9]
          && d_l >= meta[10] && d_l < meta[11];
  int top = max_radix - 1;
  Cfg x;
  x.t = axes[0 * max_radix + min(max(d_t, 0), top)];
  x.c = axes[1 * max_radix + min(max(d_c, 0), top)];
  x.h = axes[3 * max_radix + min(max(d_h, 0), top)];
  x.v = axes[2 * max_radix + min(max(d_v, 0), top)];
  x.l = axes[4 * max_radix + min(max(d_l, 0), top)];
  return x;
}

// One lane's contribution to workload w's block reduction: min (edp, lane)
// lexicographically (jnp.argmin's first hit) and the feasible count.
__device__ __forceinline__ void lane_search(const int* p, int w, Cfg x,
                                            bool valid,
                                            const float* __restrict__ cons,
                                            int lane, float& best,
                                            int& best_lane, int& nf) {
  if (!valid) return;
  float area, power;
  hw_metrics(p, w, x, area, power);
  if (!(area < cons[4 * w + 0] && power < cons[4 * w + 1])) return;
  float energy, latency;
  wl_metrics(p, w, x, power, energy, latency);
  if (!(energy < cons[4 * w + 2] && latency < cons[4 * w + 3])) return;
  float edp = energy * latency;
  ++nf;
  if (edp < best || (edp == best && lane < best_lane)) {
    best = edp;
    best_lane = lane;
  }
}

// Block-wide reduction of (best, best_lane, nf); thread 0 holds the result.
__device__ __forceinline__ void block_reduce(float& best, int& best_lane,
                                             int& nf) {
  __shared__ float s_best[32];
  __shared__ int s_lane[32];
  __shared__ int s_nf[32];
  const unsigned full = 0xffffffffu;
  for (int off = 16; off > 0; off >>= 1) {
    float b2 = __shfl_down_sync(full, best, off);
    int l2 = __shfl_down_sync(full, best_lane, off);
    nf += __shfl_down_sync(full, nf, off);
    if (b2 < best || (b2 == best && l2 < best_lane)) {
      best = b2;
      best_lane = l2;
    }
  }
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  if (lane == 0) {
    s_best[warp] = best;
    s_lane[warp] = best_lane;
    s_nf[warp] = nf;
  }
  __syncthreads();
  if (warp == 0) {
    int n_warps = blockDim.x >> 5;
    best = lane < n_warps ? s_best[lane] : INFINITY;
    best_lane = lane < n_warps ? s_lane[lane] : INT_MAX;
    nf = lane < n_warps ? s_nf[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      float b2 = __shfl_down_sync(full, best, off);
      int l2 = __shfl_down_sync(full, best_lane, off);
      nf += __shfl_down_sync(full, nf, off);
      if (b2 < best || (b2 == best && l2 < best_lane)) {
        best = b2;
        best_lane = l2;
      }
    }
  }
  __syncthreads();  // the scratch is reused for the next workload
}

// The carry rule of _search_reduce: a carried-in best that is <= the block's
// best (including exact ties and all-infeasible blocks) wins, as CARRY_IDX.
__device__ __forceinline__ void emit(float* out, int n_blocks, int w,
                                     float best, float idx, int nf,
                                     const float* __restrict__ carry) {
  float cw = carry[w];
  bool carried = cw <= best;
  int b = blockIdx.x;
  out[(kSearchRows * w + 0) * n_blocks + b] = carried ? cw : best;
  out[(kSearchRows * w + 1) * n_blocks + b] = carried ? kCarryIdx : idx;
  out[(kSearchRows * w + 2) * n_blocks + b] = static_cast<float>(nf);
}

__global__ void dse_eval_kernel(const float* __restrict__ cfg,
                                float* __restrict__ out, int g,
                                const int* __restrict__ params, int n_words) {
  extern __shared__ int sp[];
  load_params(params, n_words, sp);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g) return;
  Cfg x{cfg[i], cfg[g + i], cfg[2 * g + i], cfg[3 * g + i], cfg[4 * g + i]};
  float area, power, energy, latency;
  hw_metrics(sp, 0, x, area, power);
  wl_metrics(sp, 0, x, power, energy, latency);
  out[i] = area;
  out[g + i] = power;
  out[2 * g + i] = energy;
  out[3 * g + i] = latency;
}

__global__ void dse_search_padded_kernel(const float* __restrict__ cfg,
                                         const float* __restrict__ mask,
                                         int g,
                                         const float* __restrict__ cons,
                                         const float* __restrict__ carry,
                                         const int* __restrict__ params,
                                         int n_words, float* __restrict__ out,
                                         int n_blocks) {
  extern __shared__ int sp[];
  load_params(params, n_words, sp);
  const int base = blockIdx.x * kBlock;
  for (int w = 0; w < sp[0]; ++w) {
    float best = INFINITY;
    int best_lane = INT_MAX;
    int nf = 0;
    for (int lane = threadIdx.x; lane < kBlock; lane += blockDim.x) {
      int i = base + lane;
      if (i >= g || !(mask[i] > 0.0f)) continue;  // padding lanes
      Cfg x{cfg[i], cfg[g + i], cfg[2 * g + i], cfg[3 * g + i],
            cfg[4 * g + i]};
      lane_search(sp, w, x, true, cons, lane, best, best_lane, nf);
    }
    block_reduce(best, best_lane, nf);
    if (threadIdx.x == 0) {
      // float(base) + float(lane): the Pallas kernel's float32 index.
      float idx = static_cast<float>(base)
                  + static_cast<float>(best_lane == INT_MAX ? 0 : best_lane);
      emit(out, n_blocks, w, best, idx, nf, carry);
    }
  }
}

__global__ void dse_search_decoded_kernel(const float* __restrict__ axes,
                                          int max_radix,
                                          const int* __restrict__ meta,
                                          int r_t, int r_c, int r_v, int r_h,
                                          int r_l,
                                          const float* __restrict__ cons,
                                          const float* __restrict__ carry,
                                          const int* __restrict__ params,
                                          int n_words,
                                          float* __restrict__ out,
                                          int n_blocks) {
  extern __shared__ int sp[];
  load_params(params, n_words, sp);
  const int base = meta[0] + blockIdx.x * kDecodeBlock;
  for (int w = 0; w < sp[0]; ++w) {
    float best = INFINITY;
    int best_lane = INT_MAX;
    int nf = 0;
    for (int lane = threadIdx.x; lane < kDecodeBlock; lane += blockDim.x) {
      bool valid;
      Cfg x = decode_lane(axes, max_radix, meta, r_t, r_c, r_v, r_h, r_l,
                          base + lane, valid);
      lane_search(sp, w, x, valid, cons, lane, best, best_lane, nf);
    }
    block_reduce(best, best_lane, nf);
    if (threadIdx.x == 0) {
      float idx = static_cast<float>(
          base + (best_lane == INT_MAX ? 0 : best_lane));
      emit(out, n_blocks, w, best, idx, nf, carry);
    }
  }
}

__global__ void dse_decode_rows_kernel(const float* __restrict__ axes,
                                       int max_radix,
                                       const int* __restrict__ meta, int r_t,
                                       int r_c, int r_v, int r_h, int r_l,
                                       float* __restrict__ out, int width) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= width) return;
  bool valid;
  Cfg x = decode_lane(axes, max_radix, meta, r_t, r_c, r_v, r_h, r_l,
                      meta[0] + lane, valid);
  out[lane] = x.t;
  out[width + lane] = x.c;
  out[2 * width + lane] = x.h;
  out[3 * width + lane] = x.v;
  out[4 * width + lane] = x.l;
  out[5 * width + lane] = valid ? 1.0f : 0.0f;
}

}  // namespace

extern "C" {

int dse_eval_launch(const float* cfg, float* out, int g, const int* params,
                    int n_words, void* stream) {
  int grid = (g + kThreads - 1) / kThreads;
  if (grid > 0) {
    dse_eval_kernel<<<grid, kThreads, n_words * sizeof(int),
                      static_cast<cudaStream_t>(stream)>>>(cfg, out, g,
                                                           params, n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

int dse_search_padded_launch(const float* cfg, const float* mask, int g,
                             const float* cons, const float* carry,
                             const int* params, int n_words, float* out,
                             int n_blocks, void* stream) {
  dse_search_padded_kernel<<<n_blocks, kThreads, n_words * sizeof(int),
                             static_cast<cudaStream_t>(stream)>>>(
      cfg, mask, g, cons, carry, params, n_words, out, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

int dse_search_decoded_launch(const float* axes, int max_radix,
                              const int* meta, int r_t, int r_c, int r_v,
                              int r_h, int r_l, const float* cons,
                              const float* carry, const int* params,
                              int n_words, float* out, int n_blocks,
                              void* stream) {
  dse_search_decoded_kernel<<<n_blocks, kThreads, n_words * sizeof(int),
                              static_cast<cudaStream_t>(stream)>>>(
      axes, max_radix, meta, r_t, r_c, r_v, r_h, r_l, cons, carry, params,
      n_words, out, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

int dse_decode_rows_launch(const float* axes, int max_radix, const int* meta,
                           int r_t, int r_c, int r_v, int r_h, int r_l,
                           float* out, int n_blocks, void* stream) {
  int width = n_blocks * kBlock;
  dse_decode_rows_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      axes, max_radix, meta, r_t, r_c, r_v, r_h, r_l, out, width);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
