// Hopper (sm_90a) kernels of the DxPTA cost model and fused DSE search.
//
// Six kernels replace the six Pallas kernels of
// src/repro/kernels/dse_eval.py that carry the min-EDP and the
// Pareto-frontier co-searches:
//
//   dse_eval_kernel           <- dse_eval_padded    (_dse_kernel)
//   dse_search_padded_kernel  <- dse_search_padded  (_dse_search_kernel ->
//                                                    _search_reduce)
//   dse_search_decoded_kernel <- dse_search_decoded (_dse_search_decode_kernel
//                                                    -> _decode_block)
//   dse_decode_rows_kernel    <- dse_decode_rows    (_decode_rows_kernel)
//   dse_pareto_padded_kernel  <- dse_pareto_padded  (_dse_pareto_kernel ->
//                                                    _pareto_reduce,
//                                                    _block_front,
//                                                    _carry_dominated)
//   dse_pareto_decoded_kernel <- dse_pareto_decoded (_dse_pareto_decode_kernel)
//
// All six share one cost model (hw_metrics: area/power; wl_metrics: the
// per-GEMM dataflow half) and one mixed-radix decoder (decode_lane), as the
// Pallas file shares _config_metrics_hw/_wl and _decode_block.
//
// What bounds them: per config the model is ~55 scalar operations for the
// area/power half and ~18 per GEMM (three int32 ceil-divisions, float32
// products) for the dataflow half. The grid-operand kernels also read 20
// bytes of config (plus 4 of mask) and dse_eval writes 16, which at 3.35
// TB/s outweighs the arithmetic at 67 T op/s: they are bound by bytes.
// dse_decode_rows writes 24 bytes per lane and does little else: bytes.
// dse_search_decoded reads and writes almost nothing: operations. The two
// frontier kernels add a pairwise dominance pass, f(f-1)/2 pairs of 2d
// compares per block of f feasible lanes: operations. No matrix product
// anywhere, so the tensor cores (wgmma) and TMA have nothing to do here.
// The design keeps it simple: one thread per config lane (eight lanes per
// thread in the frontier kernels); the GEMM list and the pre-folded
// constants sit in shared memory (one small parameter block per launch);
// lanes that fail the cheap area/power half skip the GEMM loop (exact:
// feasibility needs both); each logical block (2048 lanes, 16384 decoded
// for the search) is reduced inside one CUDA block. The card has no
// integer divide instruction, so the model's integer divisions are
// division-free and exact: the GEMM ceil-divisions by an integer
// reciprocal taken once per lane and one correction (ceil_div), the
// decoder's digits by a multiply and a shift with host-computed constants
// (make_radix).
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
constexpr int kMaxFront = 128;       // emitted front indices per block
constexpr int kParetoRows = 2 + kMaxFront;
constexpr int kCarryFront = 128;     // carried front points per workload
constexpr int kDomChunk = 256;       // the reference's dominance column tile
constexpr int kBatch = 64;           // sorted columns per dominance batch
constexpr int kMaxObjectives = 5;
constexpr int kLanesPerThread = kBlock / kThreads;
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

// ceil(a / b) for 0 <= a < 2^31 and b >= 1, exact, with no division in
// the GEMM loop: each lane computes inv = floor((2^32 - 1) / b) once per
// divisor (make_divisor), then q = umulhi(a, inv) is floor(a / b) or one
// less (a * inv / 2^32 > a / b - 1 for a < 2^31), and one integer
// correction step makes it exact. (A float-reciprocal quotient needs two
// int/float conversions per division, which run at a quarter of the
// integer rate; on an H100 it was slower than an integer division.)
struct Divisor {
  int b;
  unsigned inv;
};

__device__ __forceinline__ Divisor make_divisor(int b) {
  return Divisor{b, 0xffffffffu / static_cast<unsigned>(b)};
}

__device__ __forceinline__ int ceil_div(int a, Divisor d) {
  int q = static_cast<int>(__umulhi(static_cast<unsigned>(a), d.inv));
  int rem = a - q * d.b;
  if (rem >= d.b) {
    ++q;
    rem -= d.b;
  }
  return q + (rem > 0 ? 1 : 0);
}

// _config_metrics_wl: (energy, latency) of one config for workload w.
__device__ __forceinline__ void wl_metrics(const int* p, int w, Cfg x,
                                           float power, float& energy,
                                           float& latency) {
  const int* r = wl_record(p, w);
  float lanes = (((x.t * x.h) + x.v) * x.c) * x.l;
  const Divisor d_m = make_divisor(static_cast<int>(x.t * x.h));
  const Divisor d_n = make_divisor(static_cast<int>(x.v));
  const Divisor d_k = make_divisor(static_cast<int>(x.c * x.l));
  float total = 0.0f;
  float sram_lane = 0.0f;
  for (int g = r[W_G0]; g < r[W_G1]; ++g) {
    const int* q = gemm_record(p, g);  // [m, k, n, count]
    int cm = ceil_div(q[0], d_m);
    int cn = ceil_div(q[2], d_n);
    int ck = ceil_div(q[1], d_k);
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

// n / r for 0 <= n < 2^31 by one widening multiply and a shift, exact
// (Granlund and Montgomery, 1994, Thm 4.2): with l = ceil(log2 r) and
// mul = ceil(2^(31 + l) / r), mul * r - 2^(31 + l) < r <= 2^l, so
// floor(mul * n / 2^(31 + l)) = floor(n / r), and mul < 2^32. The host
// computes (mul, shift) once per launch (make_radix).
struct Radix {
  unsigned mul;
  int shift;
  int r;
};

// The four divisors of the mixed-radix decode, in the order it divides.
struct Decoder {
  Radix l, h, v, c;
};

Radix make_radix(int r) {
  int l = 0;
  while ((1ll << l) < r) ++l;
  const unsigned long long num = 1ull << (31 + l);
  return Radix{static_cast<unsigned>((num + r - 1) / r), 31 + l, r};
}

Decoder make_decoder(int r_c, int r_v, int r_h, int r_l) {
  return Decoder{make_radix(r_l), make_radix(r_h), make_radix(r_v),
                 make_radix(r_c)};
}

// (n / r, n % r) of 0 <= n < 2^31.
__device__ __forceinline__ int div_radix(int n, Radix d, int& rem) {
  const int q = static_cast<int>(
      (static_cast<unsigned long long>(d.mul) * static_cast<unsigned>(n))
      >> d.shift);
  rem = n - q * d.r;
  return q;
}

// _decode_block for one lane: mixed-radix digits of gidx in meshgrid axis
// order (t, c, v, h, lambda), slab-validity test, clamped per-axis gather.
__device__ __forceinline__ Cfg decode_lane(const float* __restrict__ axes,
                                           int max_radix,
                                           const int* __restrict__ meta,
                                           const Decoder& dec, int gidx,
                                           bool& valid) {
  int d_l, d_h, d_v, d_c;
  int i = div_radix(gidx, dec.l, d_l);
  i = div_radix(i, dec.h, d_h);
  i = div_radix(i, dec.v, d_v);
  const int d_t = div_radix(i, dec.c, d_c);
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
                                          Decoder dec,
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
      Cfg x = decode_lane(axes, max_radix, meta, dec, base + lane, valid);
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
                                       const int* __restrict__ meta,
                                       Decoder dec, float* __restrict__ out,
                                       int width) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= width) return;
  bool valid;
  Cfg x = decode_lane(axes, max_radix, meta, dec, meta[0] + lane, valid);
  out[lane] = x.t;
  out[width + lane] = x.c;
  out[2 * width + lane] = x.h;
  out[3 * width + lane] = x.v;
  out[4 * width + lane] = x.l;
  out[5 * width + lane] = valid ? 1.0f : 0.0f;
}


// ---------------------------------------------------------------------------
// Frontier kernels: per 2048-lane block, the feasible block-local
// non-dominated set with the semantics of the Pallas _block_front (which is
// not plain dominance — a block is ordered by a stable sort on objective 0,
// and a sorted row can dominate only rows after it), then the strict
// carried-front prune and a compaction to at most kMaxFront lane indices.
//
// One CUDA block per logical block, looping over the W workloads. Per
// workload:
//   1. each thread prices eight lanes; the f feasible lanes append their
//      (monotone objective-0 key, lane) pairs to compact storage (a warp
//      ballot and one shared atomic per warp and pass: the slots' order is
//      free, since the lane in the key's low word fixes the sorted order);
//   2. a bitonic sort of those f keys, padded with all-ones keys to the
//      next power of two (one warp with shuffles when f <= 32) — the lane
//      in the low word makes it the stable order of jnp.argsort;
//   3. the objectives of the sorted rows, priced again from each row's
//      lane (few lanes are feasible, so re-pricing them is cheaper than
//      keeping 2048 lanes of objectives), and the carried points;
//   4. one warp per sorted column: its lanes stride the column's
//      dominator candidates and __any_sync stops the warp at the first
//      dominator (a column whose kDomChunk tile starts at a non-finite
//      objective 0 is skipped, as the reference's lax.cond skips the
//      tile), then the carried points; the front flag scatters back to the
//      column's lane. Columns go in batches of kBatch; the candidates are
//      the earlier rows of the batch and a list of the earlier batches'
//      rows that no earlier row dominates, less those equal to their
//      sorted predecessor (by transitivity neither kind can dominate a
//      column that a listed row does not), so a block with a small front
//      compares each column with a few rows, not with all earlier ones;
//   5. a block-wide prefix sum over the front flags in lane order and a
//      write of the first kMaxFront indices, base + lane in float32.
// Why the compaction is exact: an infeasible lane has every objective +inf.
// When every feasible objective 0 is finite (the cost model's metrics are
// finite positive floats), every infeasible key sorts after every feasible
// one, so the feasible rows are the sorted prefix and keep their positions
// (and so their kDomChunk tiles, whose first objective 0 is then finite:
// the skip only ever skips infeasible columns); an all-+inf row never
// dominates a feasible row (it is < on no objective); and infeasible
// columns are never on the front. Dropping the infeasible rows changes
// nothing. A block where some feasible objective 0 is not finite (the skip
// and the tie with +inf rows would then depend on them) sorts all 2048
// lanes instead, the infeasible ones at +inf.
// Shared memory: 8 B of key, 4d B of sorted objectives and 2 B of list
// per row (2048 rows at most), the carried points, a flag byte per lane
// and the parameter block — 49 KB at d = 3, 66 KB at d = 5, past the 48 KB
// static limit, so the launchers opt in to that much dynamic shared memory
// first.
// Blocks with no feasible lane skip steps 2-5.
// ---------------------------------------------------------------------------

// Monotone uint32 key of a float: ascending keys follow ascending values,
// -0.0 keys as +0.0 and every NaN sorts after +inf.
__device__ __forceinline__ unsigned sort_key(float v) {
  unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) == 0u) u = 0u;
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// One metric by its code in kernels/dse_eval.py:PARETO_METRICS.
__device__ __forceinline__ float pick_metric(int code, float area,
                                             float power, float energy,
                                             float latency) {
  switch (code) {
    case 0: return area;
    case 1: return power;
    case 2: return energy;
    case 3: return latency;
    default: return energy * latency;
  }
}

// True when row i of a point table (objective k of row i at
// rows[k * stride_k + i * stride_i]) strictly dominates x: <= on every
// objective and < on one.
__device__ __forceinline__ bool row_dominates(const float* rows, int stride_k,
                                              int stride_i, int i,
                                              const float (&x)[kMaxObjectives],
                                              int d) {
  bool le = true;
  bool lt = false;
#pragma unroll
  for (int k = 0; k < kMaxObjectives; ++k) {
    if (k < d) {
      float r = rows[k * stride_k + i * stride_i];
      le = le && (r <= x[k]);
      lt = lt || (r < x[k]);
    }
  }
  return le && lt;
}

__host__ __device__ constexpr size_t pareto_smem_bytes(int d, int n_words) {
  return sizeof(unsigned long long) * kBlock      // sort keys
         + sizeof(float) * d * kBlock             // sorted rows' objectives
         + sizeof(float) * kCarryFront * d        // carried points
         + kBlock                                 // feasible / front flags
         + sizeof(unsigned short) * kBlock        // listed dominator rows
         + sizeof(int) * n_words;                 // parameter block
}

// Where a frontier block's lanes come from: a (5, g) config grid with a
// mask, or the decoded span of a meta row.
struct LaneSource {
  const float* cfg;
  const float* mask;
  int g;
  const float* axes;
  int max_radix;
  const int* meta;
  Decoder dec;
  int lane0;  // the block's first index (launch-local or global)
};

// Price lane `lane` of the block for workload w; true when it is feasible,
// with its four metrics.
template <bool kDecoded>
__device__ __forceinline__ bool price_lane(const LaneSource& src,
                                           const int* sp, int w,
                                           const float* __restrict__ cons,
                                           int lane, float& area,
                                           float& power, float& energy,
                                           float& latency) {
  bool valid;
  Cfg x{1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
  if (kDecoded) {
    x = decode_lane(src.axes, src.max_radix, src.meta, src.dec,
                    src.lane0 + lane, valid);
  } else {
    const int i = src.lane0 + lane;
    valid = i < src.g && src.mask[i] > 0.0f;
    if (valid) {
      x = Cfg{src.cfg[i], src.cfg[src.g + i], src.cfg[2 * src.g + i],
              src.cfg[3 * src.g + i], src.cfg[4 * src.g + i]};
    }
  }
  if (!valid) return false;
  hw_metrics(sp, w, x, area, power);
  if (!(area < cons[4 * w + 0] && power < cons[4 * w + 1])) return false;
  wl_metrics(sp, w, x, power, energy, latency);
  return energy < cons[4 * w + 2] && latency < cons[4 * w + 3];
}

// Append this warp's flagged lanes' keys to keys[s_n...]; one shared
// atomic per warp.
__device__ __forceinline__ void append_keys(unsigned long long* keys,
                                            int* s_n, bool take,
                                            unsigned long long key) {
  const unsigned full = 0xffffffffu;
  const int wl = threadIdx.x & 31;
  const unsigned bal = __ballot_sync(full, take);
  int slot = 0;
  if (wl == 0 && bal != 0u) slot = atomicAdd(s_n, __popc(bal));
  slot = __shfl_sync(full, slot, 0);
  if (take) keys[slot + __popc(bal & ((1u << wl) - 1u))] = key;
}

// Ascending sort of keys[0, n) (n <= kBlock) in place.
__device__ __forceinline__ void sort_keys(unsigned long long* keys, int n) {
  const int tid = threadIdx.x;
  if (n <= 32) {  // one warp, in registers
    if (tid < 32) {
      unsigned long long key = tid < n ? keys[tid] : ~0ull;
      for (int k = 2; k <= 32; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, j);
          const bool keep_min = ((tid & j) == 0) == ((tid & k) == 0);
          key = keep_min ? (other < key ? other : key)
                         : (other > key ? other : key);
        }
      }
      if (tid < n) keys[tid] = key;
    }
    __syncthreads();
    return;
  }
  int n2 = 64;
  while (n2 < n) n2 <<= 1;
  for (int i = n + tid; i < n2; i += kThreads) keys[i] = ~0ull;
  __syncthreads();
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < n2 / 2; p += kThreads) {
        const int i = 2 * p - (p & (j - 1));  // bit j of i is clear
        const unsigned long long a = keys[i];
        const unsigned long long c = keys[i + j];
        if ((a > c) == ((i & k) == 0)) {
          keys[i] = c;
          keys[i + j] = a;
        }
      }
      __syncthreads();
    }
  }
}

template <bool kDecoded>
__device__ __forceinline__ void pareto_block(
    const LaneSource& src, const float* __restrict__ cons,
    const float* __restrict__ carry, int d, int codes, int has_carry,
    const int* __restrict__ params, int n_words, float* __restrict__ out,
    int n_blocks) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* keys = smem;
  float* sobj = reinterpret_cast<float*>(keys + kBlock);
  float* cpts = sobj + d * kBlock;
  unsigned char* frontf =
      reinterpret_cast<unsigned char*>(cpts + kCarryFront * d);
  unsigned short* flist = reinterpret_cast<unsigned short*>(frontf + kBlock);
  int* sp = reinterpret_cast<int*>(flist + kBlock);
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_n;
  __shared__ int s_nf;
  __shared__ unsigned char s_bat[kBatch];
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int wp = tid >> 5;
  const unsigned full = 0xffffffffu;
  if (tid == 0) s_n = 0;
  load_params(params, n_words, sp);
  const int b = blockIdx.x;
  const float base = static_cast<float>(src.lane0);
  const unsigned long long inf_key =
      static_cast<unsigned long long>(sort_key(INFINITY)) << 32;
  for (int w = 0; w < sp[0]; ++w) {
    float* o = out + static_cast<size_t>(kParetoRows) * w * n_blocks + b;
    // 1. Price the lanes; the feasible ones' keys to compact storage.
    bool odd = false;  // a feasible lane with a non-finite objective 0
    for (int r = 0; r < kLanesPerThread; ++r) {
      const int lane = r * kThreads + tid;
      float area, power, energy, latency;
      const bool ok = price_lane<kDecoded>(src, sp, w, cons, lane, area,
                                           power, energy, latency);
      const float o0 =
          ok ? pick_metric(codes & 7, area, power, energy, latency) : 0.0f;
      frontf[lane] = ok ? 1 : 0;
      odd = odd || (ok && !isfinite(o0));
      append_keys(keys, &s_n, ok,
                  (static_cast<unsigned long long>(sort_key(o0)) << 32)
                      | static_cast<unsigned>(lane));
    }
    const bool all_lanes = __syncthreads_or(odd) != 0;
#ifdef DSE_STAGE_PRICE_ONLY
    // Timing build of tools/stage_dse.py (outputs wrong by design): every
    // block takes the empty exit, so only the pricing remains.
    const int n_ok = 0 * s_n;
#else
    const int n_ok = s_n;
#endif
    if (n_ok == 0) {  // nothing feasible: counts 0, indices -1
      if (tid < kParetoRows) o[tid * n_blocks] = tid < 2 ? 0.0f : -1.0f;
    } else {
      int n_rows = n_ok;
      if (all_lanes) {  // the infeasible lanes join as +inf rows
        __syncthreads();  // every thread has read n_ok
        for (int r = 0; r < kLanesPerThread; ++r) {
          const int lane = r * kThreads + tid;
          append_keys(keys, &s_n, frontf[lane] == 0,
                      inf_key | static_cast<unsigned>(lane));
        }
        __syncthreads();
        n_rows = kBlock;
      }
      // 2. Stable sort of the rows by objective 0.
      sort_keys(keys, n_rows);
      // 3. Objectives in sorted order; the carried points of workload w.
      for (int j = tid; j < n_rows; j += kThreads) {
        const int lane = static_cast<int>(keys[j] & 0xffffffffu);
        float area, power, energy, latency;
        const bool ok = price_lane<kDecoded>(src, sp, w, cons, lane, area,
                                             power, energy, latency);
        for (int k = 0; k < d; ++k) {
          sobj[k * kBlock + j] =
              ok ? pick_metric((codes >> (3 * k)) & 7, area, power, energy,
                               latency)
                 : INFINITY;
        }
      }
      if (has_carry) {
        const float* cw = carry + static_cast<size_t>(w) * kCarryFront * d;
        for (int i = tid; i < kCarryFront * d; i += kThreads) cpts[i] = cw[i];
      }
      __syncthreads();
      // 4. Dominance, one warp per sorted column, kBatch columns at a time;
      // the warp's lanes stride the column's dominator candidates and
      // __any_sync stops it at the first dominator. The candidates are the
      // earlier rows of its batch and the listed rows of the earlier
      // batches: those no earlier row dominates (a row that one dominates
      // dominates nothing the other does not, by transitivity) and that
      // differ from their sorted predecessor on some objective (an equal
      // row adds nothing). Then the carried points.
#ifndef DSE_STAGE_NO_DOMINANCE
      int nf = 0;  // listed rows, the same in every thread
      for (int j0 = 0; j0 < n_rows; j0 += kBatch) {
        const int j1 = min(j0 + kBatch, n_rows);
        for (int j = j0 + wp; j < j1; j += kThreads / 32) {
          const int lane = static_cast<int>(keys[j] & 0xffffffffu);
          const bool ok = frontf[lane] != 0;
          bool dominated = false;
          bool front = ok;
          if (ok) {
            float x[kMaxObjectives];
#pragma unroll
            for (int k = 0; k < kMaxObjectives; ++k) {
              x[k] = k < d ? sobj[k * kBlock + j] : 0.0f;
            }
            if (isfinite(sobj[j & ~(kDomChunk - 1)])) {
              const int n_cand = nf + (j - j0);
              for (int t0 = 0; t0 < n_cand; t0 += 32) {
                const int t = t0 + wl;
                const int i = t < nf ? flist[t] : j0 + (t - nf);
                const bool dom =
                    t < n_cand && row_dominates(sobj, kBlock, 1, i, x, d);
                if (__any_sync(full, dom)) {
                  dominated = true;
                  break;
                }
              }
            }
            front = !dominated;
            if (front && has_carry) {
              for (int c0 = 0; c0 < kCarryFront; c0 += 32) {
                const bool dom = row_dominates(cpts, 1, d, c0 + wl, x, d);
                if (__any_sync(full, dom)) {
                  front = false;
                  break;
                }
              }
            }
          }
          __syncwarp();  // every lane read frontf[lane] before lane 0 writes
          if (wl == 0) {
            frontf[lane] = front ? 1 : 0;
            bool listed = ok && !dominated;
            if (listed && j > 0) {
              bool same = true;
              for (int k = 0; k < d; ++k) {
                same = same && sobj[k * kBlock + j] == sobj[k * kBlock + j - 1];
              }
              listed = !same;
            }
            s_bat[j - j0] = listed ? 1 : 0;
          }
        }
        __syncthreads();
        if (wp == 0) {  // list the batch's candidates
          for (int c = 0; c < kBatch; c += 32) {
            const bool take = j0 + c + wl < j1 && s_bat[c + wl] != 0;
            const unsigned bal = __ballot_sync(full, take);
            if (take) {
              flist[nf + __popc(bal & ((1u << wl) - 1u))] =
                  static_cast<unsigned short>(j0 + c + wl);
            }
            nf += __popc(bal);
          }
          if (wl == 0) s_nf = nf;
        }
        __syncthreads();
        nf = s_nf;
      }
#else
      // Timing build of tools/stage_dse.py (outputs wrong by design): no
      // dominance test, every feasible row is front.
      __syncthreads();
#endif
      // 5. Compaction: each thread owns eight consecutive lanes; an
      // exclusive prefix sum of their front counts gives the output rows.
      const int first = tid * kLanesPerThread;
      int cnt = 0;
      for (int q = 0; q < kLanesPerThread; ++q) cnt += frontf[first + q];
      int incl = cnt;
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(full, incl, off);
        if (wl >= off) incl += v;
      }
      if (wl == 31) s_warp[wp] = incl;
      __syncthreads();
      if (wp == 0) {
        int v = wl < kThreads / 32 ? s_warp[wl] : 0;
        for (int off = 1; off < 32; off <<= 1) {
          const int u = __shfl_up_sync(full, v, off);
          if (wl >= off) v += u;
        }
        if (wl < kThreads / 32) s_warp[wl] = v;
      }
      __syncthreads();
      const int total = s_warp[kThreads / 32 - 1];
      int pos = incl - cnt + (wp > 0 ? s_warp[wp - 1] : 0);
      for (int q = 0; q < kLanesPerThread; ++q) {
        if (frontf[first + q]) {
          if (pos < kMaxFront) {
            o[(2 + pos) * n_blocks] = base + static_cast<float>(first + q);
          }
          ++pos;
        }
      }
      if (tid >= total && tid < kMaxFront) o[(2 + tid) * n_blocks] = -1.0f;
      if (tid == 0) {
        o[0] = static_cast<float>(total);
        o[n_blocks] = static_cast<float>(n_ok);
      }
    }
    // Every thread has read s_n (n_ok) before this point: the feasible
    // path passes barriers after the read, and on the empty path the
    // count is 0 either way.
    if (tid == 0) s_n = 0;
    __syncthreads();  // shared memory is reused for the next workload
  }
}

__global__ void __launch_bounds__(kThreads) dse_pareto_padded_kernel(
    const float* __restrict__ cfg, const float* __restrict__ mask, int g,
    const float* __restrict__ cons, const float* __restrict__ carry, int d,
    int codes, int has_carry, const int* __restrict__ params, int n_words,
    float* __restrict__ out, int n_blocks) {
  const LaneSource src{cfg, mask, g, nullptr, 0, nullptr, Decoder{},
                       static_cast<int>(blockIdx.x) * kBlock};
  pareto_block<false>(src, cons, carry, d, codes, has_carry, params, n_words,
                      out, n_blocks);
}

__global__ void __launch_bounds__(kThreads) dse_pareto_decoded_kernel(
    const float* __restrict__ axes, int max_radix,
    const int* __restrict__ meta, Decoder dec,
    const float* __restrict__ cons, const float* __restrict__ carry, int d,
    int codes, int has_carry, const int* __restrict__ params, int n_words,
    float* __restrict__ out, int n_blocks) {
  const LaneSource src{nullptr, nullptr, 0, axes, max_radix, meta, dec,
                       meta[0] + static_cast<int>(blockIdx.x) * kBlock};
  pareto_block<true>(src, cons, carry, d, codes, has_carry, params, n_words,
                     out, n_blocks);
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
      axes, max_radix, meta, make_decoder(r_c, r_v, r_h, r_l), cons, carry,
      params, n_words, out, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

int dse_decode_rows_launch(const float* axes, int max_radix, const int* meta,
                           int r_t, int r_c, int r_v, int r_h, int r_l,
                           float* out, int n_blocks, void* stream) {
  int width = n_blocks * kBlock;
  dse_decode_rows_kernel<<<(width + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      axes, max_radix, meta, make_decoder(r_c, r_v, r_h, r_l), out, width);
  return static_cast<int>(cudaGetLastError());
}

int dse_pareto_padded_launch(const float* cfg, const float* mask, int g,
                             const float* cons, const float* carry, int d,
                             int codes, int has_carry, const int* params,
                             int n_words, float* out, int n_blocks,
                             void* stream) {
  const size_t smem = pareto_smem_bytes(d, n_words);
  cudaError_t err = cudaFuncSetAttribute(
      dse_pareto_padded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dse_pareto_padded_kernel<<<n_blocks, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      cfg, mask, g, cons, carry, d, codes, has_carry, params, n_words, out,
      n_blocks);
  return static_cast<int>(cudaGetLastError());
}

int dse_pareto_decoded_launch(const float* axes, int max_radix,
                              const int* meta, int r_t, int r_c, int r_v,
                              int r_h, int r_l, const float* cons,
                              const float* carry, int d, int codes,
                              int has_carry, const int* params, int n_words,
                              float* out, int n_blocks, void* stream) {
  const size_t smem = pareto_smem_bytes(d, n_words);
  cudaError_t err = cudaFuncSetAttribute(
      dse_pareto_decoded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dse_pareto_decoded_kernel<<<n_blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      axes, max_radix, meta, make_decoder(r_c, r_v, r_h, r_l), cons, carry,
      d, codes, has_carry, params, n_words, out, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory (bytes) of a frontier block at d objectives and
// n_words parameter words.
int dse_pareto_smem_bytes(int d, int n_words) {
  return static_cast<int>(pareto_smem_bytes(d, n_words));
}

}  // extern "C"
