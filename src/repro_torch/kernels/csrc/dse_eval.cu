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
// All six share one cost model (hw_prefix/hw_metrics: area/power;
// wl_tail/wl_metrics: the per-GEMM dataflow half) and one mixed-radix
// decoder (decode_digits, decode_lane), as the Pallas file shares
// _config_metrics_hw/_wl and _decode_block.
//
// What bounds them: per config the model is ~55 scalar operations for the
// area/power half and ~18 per GEMM (three int32 ceil-divisions, float32
// products) for the dataflow half; -fmad=false fuses none, so each is one
// instruction, and the card issues at most one float32 instruction per
// lane per clock. The grid-operand kernels also read 20 bytes of config
// (plus 4 of mask) and dse_eval writes 16, which at 3.35 TB/s outweighs
// the arithmetic on paper: they are bound by bytes (kernel 1 measured
// otherwise: its section). dse_decode_rows writes 24 bytes
// per lane and does little else: bytes. dse_search_decoded reads and
// writes almost nothing: operations. The two frontier kernels add a
// pairwise dominance pass, f(f-1)/2 pairs of 2d compares per block of f
// feasible lanes: operations. No matrix product anywhere, so the tensor
// cores (wgmma) and TMA have nothing to do here.
// Every kernel reads the GEMM list and the pre-folded constants from shared
// memory (one small parameter block per launch); in the search and
// frontier kernels, lanes that fail the cheap area/power half skip the GEMM
// loop (exact: feasibility needs both). Kernel 1 prices a quad of lanes a thread, sharing what the quad's lanes
// share (its section below says why); kernel 4 takes one thread per lane,
// the frontier kernels eight lanes per thread, each logical block reduced
// inside one CUDA block. The two min-EDP search kernels split each block
// across a thread-block cluster and queue the area/power survivors (their
// section below says why). The card has no integer divide instruction, so the
// model's integer divisions are division-free and exact: the GEMM
// ceil-divisions by an integer reciprocal taken once per lane and one
// correction (ceil_div), the decoder's digits by a multiply and a shift
// with host-computed constants (make_radix), or by stepping the previous
// lane's digits (next_digits).
//
// Float32 parity with the Pallas source: built with -fmad=false (no FMA
// contraction) and IEEE division; every static scalar arrives pre-folded in
// float64 and rounded once to float32 on the host (Python's left-associative
// parse decides which subtrees fold), so the operation order below is the
// Pallas kernel's, op for op.
//
// Every entry point has a plain C interface (loaded with ctypes) and returns
// cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

// The terms of _config_metrics_hw that do not depend on lambda (or on the
// workload): a thread that walks consecutive lanes recomputes them only
// when a digit above lambda moves.
struct UpperTerms {
  float t, h, v;
  float ch;                      // cores * (h + v)
  float tl;                      // t * P_LASER
  float a1, a2, a3, a4, a5;      // area terms, in the order of addition
  float q1, q2, q3, q4, q5, q6;  // power terms
};

__device__ __forceinline__ UpperTerms upper_terms(const int* p, float t,
                                                  float c, float h, float v) {
  UpperTerms u;
  const float cores = t * c;
  const float ddots = (cores * h) * v;
  const float adc_chains = (t * h) * v;
  u.t = t;
  u.h = h;
  u.v = v;
  u.ch = cores * (h + v);
  u.tl = t * kf(p, P_LASER);
  u.a1 = ddots * kf(p, A_DDOT);
  u.a2 = cores * kf(p, A_CORE);
  u.a3 = adc_chains * kf(p, A_ADC);
  u.a4 = t * kf(p, A_TILE);
  u.a5 = (kf(p, A_NET) * t) * t;
  u.q1 = (ddots * 2.0f) * kf(p, P_PD);
  u.q2 = adc_chains * kf(p, P_ADC);
  u.q3 = ddots * kf(p, P_ACC);
  u.q4 = cores * kf(p, P_CORE);
  u.q5 = t * kf(p, P_TILE);
  u.q6 = (kf(p, P_NET) * t) * t;
  return u;
}

// _config_metrics_hw up to its per-workload SRAM term, from the upper terms
// and lambda: the area and power sums in the reference's order; the
// workload adds its SRAM term, then the chip term (hw_metrics).
__device__ __forceinline__ void hw_prefix_lane(const int* p,
                                               const UpperTerms& u, float l,
                                               float& a_pre, float& q_pre) {
  const float mod_channels = u.ch * l;
  float a = mod_channels * kf(p, A_MOD);
  a = a + u.a1;
  a = a + u.a2;
  a = a + u.a3;
  a = a + u.t * (kf(p, A_COMB1) * l + kf(p, A_COMB0));
  a = a + u.a4;
  a = a + u.a5;
  float q = mod_channels * kf(p, P_MOD);
  q = q + u.q1;
  q = q + u.q2;
  q = q + u.q3;
  q = q + u.q4;
  q = q + u.t * (kf(p, P_COMB1) * l + kf(p, P_COMB0));
  q = q + ((u.tl * l) * u.h) * u.v;
  q = q + u.q5;
  q = q + u.q6;
  a_pre = a;
  q_pre = q;
}

__device__ __forceinline__ void hw_prefix(const int* p, Cfg x, float& a_pre,
                                          float& q_pre) {
  hw_prefix_lane(p, upper_terms(p, x.t, x.c, x.h, x.v), x.l, a_pre, q_pre);
}

// _config_metrics_hw: (area, power) of one config for workload w.
__device__ __forceinline__ void hw_metrics(const int* p, int w, Cfg x,
                                           float& area, float& power) {
  const int* r = wl_record(p, w);
  float a, q;
  hw_prefix(p, x, a, q);
  area = (a + __int_as_float(r[W_A_SRAM])) + kf(p, A_CHIP);
  power = (q + __int_as_float(r[W_P_SRAM])) + kf(p, P_CHIP);
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

// The workload-independent inputs of _config_metrics_wl: the lane count
// and the three GEMM tile divisors.
struct WlShared {
  float lanes;
  Divisor m, n, k;
};

__device__ __forceinline__ WlShared wl_shared(Cfg x) {
  return WlShared{(((x.t * x.h) + x.v) * x.c) * x.l,
                  make_divisor(static_cast<int>(x.t * x.h)),
                  make_divisor(static_cast<int>(x.v)),
                  make_divisor(static_cast<int>(x.c * x.l))};
}

// One GEMM's term of _config_metrics_wl: its cycles (three ceil-divisions,
// then ((f32(cm) * f32(cn)) * f32(ck)) * count) added to the running total
// and to the SRAM lane sum, in list order.
__device__ __forceinline__ void gemm_step(const int* q, const WlShared& s,
                                          float& total, float& sram_lane) {
  int cm = ceil_div(q[0], s.m);  // q: [m, k, n, count]
  int cn = ceil_div(q[2], s.n);
  int ck = ceil_div(q[1], s.k);
  float cyc = ((static_cast<float>(cm) * static_cast<float>(cn))
               * static_cast<float>(ck)) * __int_as_float(q[3]);
  total = total + cyc;
  sram_lane = sram_lane + cyc * s.lanes;
}

// _config_metrics_wl's epilogue: (energy, latency) from the summed cycles
// and SRAM lane sum of workload record r.
__device__ __forceinline__ void wl_epilogue(const int* p, const int* r,
                                            float power, float total,
                                            float sram_lane, float& energy,
                                            float& latency) {
  float t_photonic = total / kf(p, F_CLK);
  float lat = fmaxf(t_photonic, __int_as_float(r[W_T_MEM]))
              + __int_as_float(r[W_T_ELEC]);
  float sram_bytes = sram_lane * kf(p, SRAM_SCALE);
  energy = (power * lat + __int_as_float(r[W_E_DRAM]))
           + sram_bytes * kf(p, E_SRAM);
  latency = lat;
}

// _config_metrics_wl from its shared inputs: (energy, latency) of one
// config for workload w.
__device__ __forceinline__ void wl_tail(const int* p, int w,
                                        const WlShared& s, float power,
                                        float& energy, float& latency) {
  const int* r = wl_record(p, w);
  float total = 0.0f;
  float sram_lane = 0.0f;
  for (int g = r[W_G0]; g < r[W_G1]; ++g) {
    gemm_step(gemm_record(p, g), s, total, sram_lane);
  }
  wl_epilogue(p, r, power, total, sram_lane, energy, latency);
}

// _config_metrics_wl: (energy, latency) of one config for workload w.
__device__ __forceinline__ void wl_metrics(const int* p, int w, Cfg x,
                                           float power, float& energy,
                                           float& latency) {
  wl_tail(p, w, wl_shared(x), power, energy, latency);
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

// Mixed-radix digits of a global index in meshgrid axis order (t, c, v,
// h, lambda), lambda fastest; d.t is the unbounded leading quotient.
struct Digits {
  int t, c, v, h, l;
};

__device__ __forceinline__ Digits decode_digits(const Decoder& dec,
                                                int gidx) {
  Digits d;
  int i = div_radix(gidx, dec.l, d.l);
  i = div_radix(i, dec.h, d.h);
  i = div_radix(i, dec.v, d.v);
  d.t = div_radix(i, dec.c, d.c);
  return d;
}

// Steps d to the digits of gidx + 1, exactly and without a multiply:
// lambda steps, and a digit that reaches its radix wraps to 0 and carries
// into the next one. True when a digit above lambda moved.
__device__ __forceinline__ bool next_digits(const Decoder& dec, Digits& d) {
  if (++d.l < dec.l.r) return false;
  d.l = 0;
  d.h += 1;
  bool carry = d.h == dec.h.r;
  d.h = carry ? 0 : d.h;
  d.v += carry;
  carry = d.v == dec.v.r;
  d.v = carry ? 0 : d.v;
  d.c += carry;
  carry = d.c == dec.c.r;
  d.c = carry ? 0 : d.c;
  d.t += carry;
  return true;
}

// The span and slab digit ranges of a meta row, loaded side by side.
struct Slab {
  int end, lo_t, hi_t, lo_c, hi_c, lo_v, hi_v, lo_h, hi_h, lo_l, hi_l;
};

__device__ __forceinline__ Slab load_slab(const int* __restrict__ meta) {
  return Slab{meta[1], meta[2], meta[3], meta[4], meta[5], meta[6],
              meta[7], meta[8], meta[9], meta[10], meta[11]};
}

// _decode_block's validity: inside the span and the slab's digit ranges,
// split into the digits above lambda and the rest.
__device__ __forceinline__ bool upper_in_slab(const Slab& s, Digits d) {
  return (d.t >= s.lo_t) & (d.t < s.hi_t) & (d.c >= s.lo_c) & (d.c < s.hi_c)
         & (d.v >= s.lo_v) & (d.v < s.hi_v) & (d.h >= s.lo_h)
         & (d.h < s.hi_h);
}

__device__ __forceinline__ bool lane_in_slab(const Slab& s, int gidx, int l) {
  return (gidx < s.end) & (l >= s.lo_l) & (l < s.hi_l);
}

__device__ __forceinline__ bool in_slab(const Slab& s, int gidx, Digits d) {
  return upper_in_slab(s, d) & lane_in_slab(s, gidx, d.l);
}

// _decode_block's clamped per-axis gather.
__device__ __forceinline__ Cfg gather_cfg(const float* __restrict__ axes,
                                          int max_radix, Digits d) {
  const int top = max_radix - 1;
  Cfg x;
  x.t = axes[0 * max_radix + min(max(d.t, 0), top)];
  x.c = axes[1 * max_radix + min(max(d.c, 0), top)];
  x.h = axes[3 * max_radix + min(max(d.h, 0), top)];
  x.v = axes[2 * max_radix + min(max(d.v, 0), top)];
  x.l = axes[4 * max_radix + min(max(d.l, 0), top)];
  return x;
}

// _decode_block for one lane: digits, slab-validity test, gather.
__device__ __forceinline__ Cfg decode_lane(const float* __restrict__ axes,
                                           int max_radix,
                                           const int* __restrict__ meta,
                                           const Decoder& dec, int gidx,
                                           bool& valid) {
  const Digits d = decode_digits(dec, gidx);
  valid = in_slab(load_slab(meta), gidx, d);
  return gather_cfg(axes, max_radix, d);
}

// ---------------------------------------------------------------------------
// Kernel 1, dse_eval_padded: (area, power, energy, latency) of every config
// lane of a (5, G) column operand, for one workload.
//
// What bounds it: 36 bytes a lane (five config floats in, four metrics
// out) against the cost model's instructions, most of them in the GEMM
// loop. What held the parent's one-lane-a-thread design back
// (tools/stage_dse.py on an H100): a launch that only reads and writes its
// lanes took 0.0037 ms at 12^5 and 0.098 ms at 24^5 (1.14x the byte
// bound), the area/power half added nothing measurable, and the GEMM loop
// (three ceil-divisions and three int-to-float conversions a GEMM, every
// lane on its own) added 0.0044 and 0.075 ms: the kernel was bound by
// instruction issue, at 2.0x its byte bound at 24^5. Tensor cores and TMA
// have nothing to do here: there is no matrix product, and a thread's share
// of a column is 16 bytes.
//
// The design (tools/stage_dse.py times each choice against a design
// build):
//   * a thread prices a quad of consecutive lanes, read and written with
//     one 16-byte access a row. A launch whose G is not a multiple of 4 or
//     whose columns are not 16-byte aligned keeps one lane a thread;
//   * where the quad's lanes hold the same (n_t, n_c, n_h, n_v) bits, as
//     the consecutive lanes of a product grid do (lambda varies fastest),
//     the terms above lambda, the M and N tile divisors and, per GEMM, the
//     M and N factors and their product are computed once for the quad
//     (the parent's one-lane-a-thread design is timed by
//     `tools/stage_dse.py --base`). These are the same operations on the
//     same values, so each lane's result is the one-lane kernel's. A quad
//     whose lanes differ prices them one at a time with the one-lane code,
//     reread from the cache;
//   * a factor is recomputed only when its dimension differs from the
//     previous GEMM's (k1-no-reuse recomputes all): the paper workloads
//     repeat them, deit-b's eight GEMMs hold four distinct M, four K and
//     six N;
//   * a launch too small to give every SM a CTA one lane a thread (the
//     Pareto BnB prices its running front, 15-200 rows, this way) keeps
//     one lane a thread: a quad a thread would only lengthen the one
//     CTA's chain;
//   * a CTA per 256 quads. A grid capped at the CTAs the SMs hold at once,
//     striding over the quads so that each CTA loads the parameter block
//     once, timed no better on an H100.
// ---------------------------------------------------------------------------

constexpr int kQuad = 4;

// The quad of lanes [i0, i0 + kQuad) of the (5, g) columns, one 16-byte
// load a row (g % kQuad == 0, 16-byte aligned columns).
__device__ __forceinline__ void load_quad(const float* __restrict__ cfg,
                                          int g, int i0, Cfg (&x)[kQuad]) {
  float4 r[5];
#pragma unroll
  for (int row = 0; row < 5; ++row) {
    r[row] = reinterpret_cast<const float4*>(cfg + row * g)[i0 / kQuad];
  }
  x[0] = Cfg{r[0].x, r[1].x, r[2].x, r[3].x, r[4].x};
  x[1] = Cfg{r[0].y, r[1].y, r[2].y, r[3].y, r[4].y};
  x[2] = Cfg{r[0].z, r[1].z, r[2].z, r[3].z, r[4].z};
  x[3] = Cfg{r[0].w, r[1].w, r[2].w, r[3].w, r[4].w};
}

__device__ __forceinline__ void store_quad(float* __restrict__ out, int g,
                                           int i0,
                                           const float (&o)[4][kQuad]) {
#pragma unroll
  for (int row = 0; row < 4; ++row) {
    reinterpret_cast<float4*>(out + row * g)[i0 / kQuad] =
        make_float4(o[row][0], o[row][1], o[row][2], o[row][3]);
  }
}

__device__ __forceinline__ bool same_upper(Cfg a, Cfg b) {
  return (__float_as_int(a.t) == __float_as_int(b.t))
         & (__float_as_int(a.c) == __float_as_int(b.c))
         & (__float_as_int(a.h) == __float_as_int(b.h))
         & (__float_as_int(a.v) == __float_as_int(b.v));
}

// One lane i of the (5, g) columns, priced and stored as the one-lane
// kernel of the parent design did.
__device__ __forceinline__ void eval_lane(const int* p,
                                          const float* __restrict__ cfg,
                                          float* __restrict__ out, int g,
                                          int i) {
  Cfg x{cfg[i], cfg[g + i], cfg[2 * g + i], cfg[3 * g + i], cfg[4 * g + i]};
  float area, power, energy, latency;
#if defined(DSE_STAGE_IO_ONLY)
  area = x.t;
  power = x.c;
  energy = x.h;
  latency = x.v + x.l;
#elif defined(DSE_STAGE_HW_ONLY)
  hw_metrics(p, 0, x, area, power);
  energy = x.h;
  latency = x.v + x.l;
#else
  hw_metrics(p, 0, x, area, power);
  wl_metrics(p, 0, x, power, energy, latency);
#endif
  out[i] = area;
  out[g + i] = power;
  out[2 * g + i] = energy;
  out[3 * g + i] = latency;
}

// _config_metrics_hw and _config_metrics_wl of a quad whose lanes share
// (n_t, n_c, n_h, n_v): o[row][j] is lane j's [area, power, energy,
// latency][row]. Every value is the one-lane kernel's, op for op.
__device__ __forceinline__ void price_quad(const int* p,
                                           const Cfg (&x)[kQuad],
                                           float (&o)[4][kQuad]) {
  const int* r = wl_record(p, 0);
#if defined(DSE_STAGE_IO_ONLY)
  // Timing build of tools/stage_dse.py (outputs wrong by design): the
  // lanes are read and written, nothing is priced.
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
    o[0][j] = x[j].t;
    o[1][j] = x[j].c;
    o[2][j] = x[j].h;
    o[3][j] = x[j].v + x[j].l;
  }
#else
  const UpperTerms u = upper_terms(p, x[0].t, x[0].c, x[0].h, x[0].v);
  const float th = x[0].t * x[0].h;
  const float thvc = (th + x[0].v) * x[0].c;
  float total[kQuad], sram_lane[kQuad], lanes[kQuad];
  Divisor dk[kQuad];
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
    float a, q;
    hw_prefix_lane(p, u, x[j].l, a, q);
    o[0][j] = (a + __int_as_float(r[W_A_SRAM])) + kf(p, A_CHIP);
    o[1][j] = (q + __int_as_float(r[W_P_SRAM])) + kf(p, P_CHIP);
    dk[j] = make_divisor(static_cast<int>(x[0].c * x[j].l));
    lanes[j] = thvc * x[j].l;
    total[j] = 0.0f;
    sram_lane[j] = 0.0f;
  }
#if defined(DSE_STAGE_HW_ONLY)
  // Timing build of tools/stage_dse.py (outputs wrong by design): the
  // area/power half only.
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
    o[2][j] = x[j].h;
    o[3][j] = x[j].v + x[j].l;
  }
#else
  const Divisor dm = make_divisor(static_cast<int>(th));
  const Divisor dn = make_divisor(static_cast<int>(x[0].v));
  // Each factor is recomputed only when its dimension differs from the
  // previous GEMM's.
  int pm = -1, pn = -1, pk = -1;
  float fm = 0.0f, fn = 0.0f, fk[kQuad];
  for (int gi = r[W_G0]; gi < r[W_G1]; ++gi) {
    const int* q = gemm_record(p, gi);  // [m, k, n, count]
#if defined(DSE_EVAL_NO_REUSE)
    // Design build of tools/stage_dse.py: every factor of every GEMM.
    pm = pn = pk = -1;
#endif
    if (q[0] != pm) {
      pm = q[0];
      fm = static_cast<float>(ceil_div(pm, dm));
    }
    if (q[2] != pn) {
      pn = q[2];
      fn = static_cast<float>(ceil_div(pn, dn));
    }
    if (q[1] != pk) {
      pk = q[1];
#pragma unroll
      for (int j = 0; j < kQuad; ++j) {
        fk[j] = static_cast<float>(ceil_div(pk, dk[j]));
      }
    }
    const float mn = fm * fn;
    const float cnt = __int_as_float(q[3]);
#pragma unroll
    for (int j = 0; j < kQuad; ++j) {
      const float cyc = (mn * fk[j]) * cnt;
      total[j] = total[j] + cyc;
      sram_lane[j] = sram_lane[j] + cyc * lanes[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kQuad; ++j) {
    wl_epilogue(p, r, o[1][j], total[j], sram_lane[j], o[2][j], o[3][j]);
  }
#endif
#endif
}

// One lane a thread (no quads), or a quad a thread. The quad instance is
// held to four CTAs an SM (64 registers): left to itself ptxas gives it
// 74-75, three CTAs an SM, which ran the 24^5 space about 10 % slower on an
// H100. The one-lane instance is held to the parent design's 32 registers
// (eight CTAs an SM): under the quads' bound ptxas gave it 44, and it ran
// the 24^5 space 10 % slower than the parent's build.
template <bool kQuads>
__global__ void __launch_bounds__(kThreads, kQuads ? 4 : 8) dse_eval_kernel(
    const float* __restrict__ cfg, float* __restrict__ out, int g,
    const int* __restrict__ params, int n_words) {
  extern __shared__ int sp[];
  load_params(params, n_words, sp);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if constexpr (!kQuads) {
    if (k < g) eval_lane(sp, cfg, out, g, k);
  } else {
    const int i0 = k * kQuad;
    if (i0 >= g) return;
    Cfg x[kQuad];
    load_quad(cfg, g, i0, x);
    bool shared = true;
#pragma unroll
    for (int j = 1; j < kQuad; ++j) shared &= same_upper(x[0], x[j]);
    if (!shared) {  // one lane at a time, reread from the cache
#pragma unroll 1
      for (int i = i0; i < i0 + kQuad; ++i) eval_lane(sp, cfg, out, g, i);
      return;
    }
    float o[4][kQuad];
    price_quad(sp, x, o);
    store_quad(out, g, i0, o);
  }
}

// ---------------------------------------------------------------------------
// Min-EDP search kernels (dse_search_padded, dse_search_decoded): per
// logical block of kBlock grid lanes or kDecodeBlock decoded lanes and per
// workload, the lexicographic minimum of (EDP, lane) over the feasible
// lanes (jnp.argmin's first hit), their count, and the carry rule.
//
// What held a one-CTA-per-block design back (tools/stage_dse.py): 486 CTAs
// at 24^5 (122 at 12^5) for 132 SMs, where the blocks rich in area/power
// survivors set the time; the survivors' dataflow half ran inside the lane
// loop, so a warp with one survivor ran its GEMM loop for all 32 lanes;
// the slab test waited on one global load after another; and a launch of
// W workloads decoded every lane W times.
//
// The design:
//   * a logical block is a cluster of kSplit CTAs of kThreads threads (256
//     grid lanes, one a thread, or 2048 decoded lanes, a run of kRun
//     consecutive ones a thread), so eight times as many, smaller CTAs
//     share out the SMs. Each CTA reduces its lanes; the cluster's leader
//     (rank 0) gathers the kSplit partials through distributed shared
//     memory, combines them, applies the carry rule and writes the block's
//     rows. The reduction is a minimum over (EDP key, lane) and a sum, so
//     the split cannot change the result;
//   * pass 1 reads or decodes each lane once for up to kGroup workloads,
//     prices the workload-independent area/power prefix once (a decoding
//     thread steps its run's digits and recomputes the terms above lambda
//     only when one of those digits moves) and each workload's tail, and
//     queues the lanes that pass some workload's area/power bounds, with a
//     mask of those workloads, in shared memory;
//   * pass 2 prices the queued lanes' dataflow half with every thread on
//     its own entry: the tile divisors once per lane, then each workload
//     of its mask; each warp folds its feasible lanes' minimum key and
//     count into the CTA's with one shared atomic each;
//   * the meta row sits in registers; the folded constants come from the
//     shared parameter block, as in the other kernels. Left to itself,
//     ptxas keeps them in registers across the decoded kernel's unrolled
//     run (57 a thread: four CTAs an SM, which ran slower at W = 1 on an
//     H100), so that kernel asks for five CTAs an SM (48 registers).
// The key of a feasible lane is (sort_key(EDP) << 32) | lane: sort_key is
// monotone, so the smallest key holds the smallest EDP at its lowest lane.
// A NaN EDP keys after +inf and never wins (as `<` never picks it); -0.0
// keys as +0.0, so it ties with +0.0 as `==` does, and comes out as +0.0.
// ---------------------------------------------------------------------------

constexpr int kSplit = 8;   // CTAs (one cluster) per logical search block
constexpr int kGroup = 32;  // workloads a pass over the lanes serves
constexpr int kPadLanes = kBlock / kSplit;        // grid lanes per CTA
constexpr int kDecLanes = kDecodeBlock / kSplit;  // decoded lanes per CTA
constexpr int kRun = kDecLanes / kThreads;        // consecutive, per thread
static_assert(kPadLanes == kThreads, "one grid lane a thread");
// (sort_key(+inf) << 32) | 0xffffffff: no feasible lane.
constexpr unsigned long long kNoKey = 0xff800000ffffffffull;

// Monotone uint32 key of a float: ascending keys follow ascending values,
// -0.0 keys as +0.0 and every NaN sorts after +inf.
__device__ __forceinline__ unsigned sort_key(float v) {
  unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) == 0u) u = 0u;
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float of a key that sort_key made from a number (+0.0 for zeros).
__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The upper terms of the config at digits d, inside its slab: there every
// digit is below its radix (<= max_radix) but the leading one, which a
// span past the space can push past its axis, so only it needs
// gather_cfg's clamp.
__device__ __forceinline__ UpperTerms upper_at(const int* p,
                                               const float* __restrict__ axes,
                                               int max_radix, Digits d) {
  return upper_terms(p, axes[min(d.t, max_radix - 1)],
                     axes[max_radix + d.c], axes[3 * max_radix + d.h],
                     axes[2 * max_radix + d.v]);
}

// One workload of a pass: its area/power tail terms, its four bounds and
// its carried-in best EDP.
struct GroupWl {
  float a_sram, p_sram, ca, cp, ce, cl, carry;
};

template <int kLanes>
struct SearchSmem {
  unsigned short q_lane[kLanes];  // queued lanes (CTA-local)
  unsigned q_mask[kLanes];        // and the workloads each passes
  GroupWl wl[kGroup];
  unsigned long long key[kGroup];  // the CTA's minimum key per workload
  int nf[kGroup];                  // and its feasible count
  unsigned long long part_key[kSplit][kGroup];  // the leader's: every
  int part_nf[kSplit][kGroup];                  // CTA's partials
  int n_queue;
};

// Set up a pass over workloads [w0, w0 + nw).
template <int kLanes>
__device__ __forceinline__ void start_group(SearchSmem<kLanes>& sm,
                                            const int* p,
                                            const float* __restrict__ cons,
                                            const float* __restrict__ carry,
                                            int w0, int nw) {
  const int j = threadIdx.x;
  if (j < nw) {
    const int* r = wl_record(p, w0 + j);
    const float* c = cons + 4 * (w0 + j);
    sm.wl[j] = GroupWl{__int_as_float(r[W_A_SRAM]),
                       __int_as_float(r[W_P_SRAM]), c[0], c[1], c[2], c[3],
                       carry[w0 + j]};
    sm.key[j] = kNoKey;
    sm.nf[j] = 0;
  }
  if (j == 0) sm.n_queue = 0;
  __syncthreads();
}

// Bit j set when a lane with prefix (a_pre, q_pre) passes workload j's
// area and power bounds; w0 is the pass's first workload, in registers.
__device__ __forceinline__ unsigned group_mask(const int* p,
                                               const GroupWl& w0,
                                               const GroupWl* wl, int nw,
                                               float a_pre, float q_pre) {
  unsigned mask = 0u;
  float area = (a_pre + w0.a_sram) + kf(p, A_CHIP);
  float power = (q_pre + w0.p_sram) + kf(p, P_CHIP);
  if (area < w0.ca && power < w0.cp) mask = 1u;
  for (int j = 1; j < nw; ++j) {
    area = (a_pre + wl[j].a_sram) + kf(p, A_CHIP);
    power = (q_pre + wl[j].p_sram) + kf(p, P_CHIP);
    if (area < wl[j].ca && power < wl[j].cp) mask |= 1u << j;
  }
  return mask;
}

// Queue a lane whose mask is not 0; one shared atomic per warp. Every
// thread of the warp calls it.
template <int kLanes>
__device__ __forceinline__ void enqueue(SearchSmem<kLanes>& sm, int lane,
                                        unsigned mask) {
  const unsigned full = 0xffffffffu;
  const int wl = threadIdx.x & 31;
  const unsigned bal = __ballot_sync(full, mask != 0u);
  if (bal == 0u) return;
  int slot = 0;
  if (wl == 0) slot = atomicAdd(&sm.n_queue, __popc(bal));
  slot = __shfl_sync(full, slot, 0);
  if (mask != 0u) {
    const int at = slot + __popc(bal & ((1u << wl) - 1u));
    sm.q_lane[at] = static_cast<unsigned short>(lane);
    sm.q_mask[at] = mask;
  }
}

// Where pass 2 finds a queued lane's config: the grid operand, or the
// decoder (lanes block-local, from the block's first index).
struct PaddedSrc {
  const float* cfg;
  int g;
  int base;
  __device__ __forceinline__ Cfg at(int lane) const {
    const int i = base + lane;
    return Cfg{cfg[i], cfg[g + i], cfg[2 * g + i], cfg[3 * g + i],
               cfg[4 * g + i]};
  }
};

struct DecodedSrc {
  const float* axes;
  int max_radix;
  const Decoder& dec;
  int base;
  __device__ __forceinline__ Cfg at(int lane) const {
    return gather_cfg(axes, max_radix, decode_digits(dec, base + lane));
  }
};

// The dataflow half of one lane per thread (every thread of the warp
// calls it; mask 0: none): for each workload of its mask, the lane's
// energy and latency from its power prefix q_pre and shared inputs ws;
// each warp folds its feasible lanes' minimum key and count into the CTA's.
template <int kLanes>
__device__ __forceinline__ void fold_dataflow(
    SearchSmem<kLanes>& sm, const int* p, int w0, int nw, int lane,
    unsigned mask, float q_pre, const WlShared& ws) {
  const unsigned full = 0xffffffffu;
  for (int j = 0; j < nw; ++j) {
    bool ok = false;
    float edp = 0.0f;
    if ((mask >> j) & 1u) {
      const float power = (q_pre + sm.wl[j].p_sram) + kf(p, P_CHIP);
      float energy, latency;
      wl_tail(p, w0 + j, ws, power, energy, latency);
      ok = energy < sm.wl[j].ce && latency < sm.wl[j].cl;
      edp = energy * latency;
    }
    // The warp's minimum (key, lane): the least key, then the least lane
    // holding it (two warp reductions instead of a 64-bit shuffle tree).
    const unsigned hi = ok ? sort_key(edp) : 0xffffffffu;
    const unsigned best = __reduce_min_sync(full, hi);
    const unsigned at = __reduce_min_sync(
        full, ok && hi == best ? static_cast<unsigned>(lane) : 0xffffffffu);
    const unsigned bal = __ballot_sync(full, ok);
    if ((threadIdx.x & 31) == 0 && bal != 0u) {
      atomicMin(&sm.key[j],
                (static_cast<unsigned long long>(best) << 32) | at);
      atomicAdd(&sm.nf[j], __popc(bal));
    }
  }
}

// Pass 2: the dataflow half of the queued lanes (lane0: the block-local
// lane of the CTA's first).
template <int kLanes, class Src>
__device__ __forceinline__ void search_queued(SearchSmem<kLanes>& sm,
                                              const Src& src, const int* p,
                                              int w0, int nw, int lane0) {
#if defined(DSE_STAGE_HW_ONLY) || defined(DSE_STAGE_DECODE_ONLY)
  // Timing builds of tools/stage_dse.py (outputs wrong by design): no
  // dataflow half.
  const int n = 0 * sm.n_queue;
#else
  const int n = sm.n_queue;
#endif
  for (int e0 = 0; e0 < n; e0 += kThreads) {
    const int e = e0 + static_cast<int>(threadIdx.x);
    if (!__any_sync(0xffffffffu, e < n)) break;  // the warp's entries are done
    unsigned mask = 0u;
    int lane = 0;
    float q_pre = 0.0f;
    WlShared ws{};
    if (e < n) {
      lane = lane0 + sm.q_lane[e];
      mask = sm.q_mask[e];
      const Cfg x = src.at(lane);
      float a_pre;
      hw_prefix(p, x, a_pre, q_pre);
      ws = wl_shared(x);
    }
    fold_dataflow(sm, p, w0, nw, lane, mask, q_pre, ws);
  }
}

// The carry rule of _search_reduce: a carried-in best cw that is <= the
// block's best (including exact ties and all-infeasible blocks) wins, as
// CARRY_IDX.
__device__ __forceinline__ void emit(float* out, int n_blocks, int b, int w,
                                     float best, float idx, int nf,
                                     float cw) {
  bool carried = cw <= best;
  out[(kSearchRows * w + 0) * n_blocks + b] = carried ? cw : best;
  out[(kSearchRows * w + 1) * n_blocks + b] = carried ? kCarryIdx : idx;
  out[(kSearchRows * w + 2) * n_blocks + b] = static_cast<float>(nf);
}

// The cluster's reduction of a pass: each CTA stores its minimum key and
// count in the leader's (rank 0) shared memory; the leader combines them
// and writes block blk's rows. base: the block's first index
// (launch-local for the grid operand, whose float32 index is float(base) +
// float(lane); global when decoded).
template <bool kDecoded, int kLanes>
__device__ __forceinline__ void finish_group(SearchSmem<kLanes>& sm, int w0,
                                             int nw, int blk, int base,
                                             float* __restrict__ out,
                                             int n_blocks) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int j = threadIdx.x;
  // Every CTA of the cluster runs and is done with its atomics, and the
  // leader is done with the previous pass's partials.
  cluster.sync();
  if (j < nw) {
    SearchSmem<kLanes>* lead = cluster.map_shared_rank(&sm, 0);
    lead->part_key[rank][j] = sm.key[j];
    lead->part_nf[rank][j] = sm.nf[j];
  }
  cluster.sync();  // the leader's memory stays until every share is in
  if (rank == 0 && j < nw) {
    unsigned long long key = kNoKey;
    int nf = 0;
    for (int r = 0; r < kSplit; ++r) {
      key = sm.part_key[r][j] < key ? sm.part_key[r][j] : key;
      nf += sm.part_nf[r][j];
    }
    const unsigned lane = static_cast<unsigned>(key & 0xffffffffu);
    const int l = lane == 0xffffffffu ? 0 : static_cast<int>(lane);
    const float idx = kDecoded
                          ? static_cast<float>(base + l)
                          : static_cast<float>(base) + static_cast<float>(l);
    emit(out, n_blocks, blk, w0 + j,
         key_value(static_cast<unsigned>(key >> 32)), idx, nf,
         sm.wl[j].carry);
  }
}

__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
dse_search_padded_kernel(const float* __restrict__ cfg,
                         const float* __restrict__ mask, int g,
                         const float* __restrict__ cons,
                         const float* __restrict__ carry,
                         const int* __restrict__ params, int n_words,
                         float* __restrict__ out, int n_blocks) {
  __shared__ SearchSmem<kPadLanes> sm;
  extern __shared__ int sp[];
  const int blk = blockIdx.x / kSplit;
  const int lane0 =
      static_cast<int>(cooperative_groups::this_cluster().block_rank())
      * kPadLanes;
  const PaddedSrc src{cfg, g, blk * kBlock};
  const int lane = lane0 + static_cast<int>(threadIdx.x);  // block-local
  bool valid = false;  // past g: padding lanes
  Cfg x{1.0f, 1.0f, 1.0f, 1.0f, 1.0f};
  if (src.base + lane < g) {  // the config and the mask loads side by side
    valid = mask[src.base + lane] > 0.0f;
    x = src.at(lane);
  }
  load_params(params, n_words, sp);
  const int n_wl = sp[0];
  for (int w0 = 0; w0 < n_wl; w0 += kGroup) {
    const int nw = min(kGroup, n_wl - w0);
    start_group(sm, sp, cons, carry, w0, nw);
    unsigned m = 0u;
    if (valid) {
#if defined(DSE_STAGE_DECODE_ONLY)
      // Timing build of tools/stage_dse.py (outputs wrong by design): the
      // lanes are read, nothing is priced or queued.
      m = ((((x.t + x.c) + x.h) + x.v) + x.l < 0.0f) ? 1u : 0u;
#else
      float a_pre, q_pre;
      hw_prefix(sp, x, a_pre, q_pre);
      m = group_mask(sp, sm.wl[0], sm.wl, nw, a_pre, q_pre);
#endif
    }
    enqueue(sm, threadIdx.x, m);
    __syncthreads();
    search_queued(sm, src, sp, w0, nw, lane0);
    finish_group<false>(sm, w0, nw, blk, src.base, out, n_blocks);
  }
}

__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 5)
dse_search_decoded_kernel(const float* __restrict__ axes, int max_radix,
                          const int* __restrict__ meta,
                          const __grid_constant__ Decoder dec,
                          const float* __restrict__ cons,
                          const float* __restrict__ carry,
                          const int* __restrict__ params, int n_words,
                          float* __restrict__ out, int n_blocks) {
  __shared__ SearchSmem<kDecLanes> sm;
  extern __shared__ int sp[];
  const Slab slab = load_slab(meta);
  const int blk = blockIdx.x / kSplit;
  const int lane0 =
      static_cast<int>(cooperative_groups::this_cluster().block_rank())
      * kDecLanes;
  const DecodedSrc src{axes, max_radix, dec, meta[0] + blk * kDecodeBlock};
  // This thread's run: CTA-local lanes [first, first + kRun).
  const int first = static_cast<int>(threadIdx.x) * kRun;
  const int gidx0 = src.base + lane0 + first;
  const Digits d0 = decode_digits(dec, gidx0);
  const float* ax_l = axes + 4 * max_radix;
  load_params(params, n_words, sp);
  const int n_wl = sp[0];
  for (int w0 = 0; w0 < n_wl; w0 += kGroup) {
    const int nw = min(kGroup, n_wl - w0);
    start_group(sm, sp, cons, carry, w0, nw);
    const GroupWl g0 = sm.wl[0];
    Digits d = d0;
    UpperTerms u = upper_at(sp, axes, max_radix, d);
    bool upper_ok = upper_in_slab(slab, d);
#pragma unroll
    for (int r = 0; r < kRun; ++r) {
      if (r > 0 && next_digits(dec, d)) {  // a digit above lambda moved
        u = upper_at(sp, axes, max_radix, d);
        upper_ok = upper_in_slab(slab, d);
      }
      unsigned m = 0u;
      if (upper_ok & lane_in_slab(slab, gidx0 + r, d.l)) {
        const float l = ax_l[d.l];
#if defined(DSE_STAGE_DECODE_ONLY)
        // Timing build of tools/stage_dse.py (outputs wrong by design):
        // the lanes are decoded, nothing is priced or queued.
        m = (((u.t + u.h) + u.v) + l < 0.0f) ? 1u : 0u;
#else
        float a_pre, q_pre;
        hw_prefix_lane(sp, u, l, a_pre, q_pre);
        m = group_mask(sp, g0, sm.wl, nw, a_pre, q_pre);
#endif
      }
      enqueue(sm, first + r, m);
    }
    __syncthreads();
    search_queued(sm, src, sp, w0, nw, lane0);
    finish_group<true>(sm, w0, nw, blk, src.base, out, n_blocks);
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
  if (g <= 0) return static_cast<int>(cudaGetLastError());
  const int smem = n_words * static_cast<int>(sizeof(int));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  int n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const bool quads = g >= kThreads * n_sm && g % kQuad == 0
                     && reinterpret_cast<uintptr_t>(cfg) % 16 == 0
                     && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (quads) {
    dse_eval_kernel<true><<<(g / kQuad + kThreads - 1) / kThreads, kThreads,
                            smem, st>>>(cfg, out, g, params, n_words);
  } else {  // one lane a thread
    dse_eval_kernel<false><<<(g + kThreads - 1) / kThreads, kThreads, smem,
                             st>>>(cfg, out, g, params, n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

// A search kernel's static shared memory and a parameter block near its
// limit (MAX_PARAM_WORDS) pass the 48 KB a block gets without opting in, so
// the launchers opt in to the block's size.
int dse_search_padded_launch(const float* cfg, const float* mask, int g,
                             const float* cons, const float* carry,
                             const int* params, int n_words, float* out,
                             int n_blocks, void* stream) {
  const int smem = n_words * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      dse_search_padded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dse_search_padded_kernel<<<n_blocks * kSplit, kThreads, smem,
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
  const int smem = n_words * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      dse_search_decoded_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dse_search_decoded_kernel<<<n_blocks * kSplit, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      axes, max_radix, meta, make_decoder(r_c, r_v, r_h, r_l), cons, carry,
      params, n_words, out, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// CTAs (one cluster) per logical block of the two search kernels.
int dse_search_split() { return kSplit; }

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
