// Hopper (sm_90a) kernels of the LM path: the photonic DDot GEMM and the
// fused attention forward.
//
//   ddot_gemm_kernel       <- src/repro/kernels/ddot_gemm.py
//                             ddot_gemm_quantized (_ddot_kernel)
//   flash_attention_kernel <- src/repro/kernels/flash_attention.py
//                             flash_attention_bhsd (_flash_kernel)
//
// ddot_gemm_kernel: out = ((acc [+ (noise_rms * sqrt(pow)) * z]) * sa) * sb
// with acc = qa @ qb and pow = |qa| @ |qb| over 4-bit integer operands in
// [-7, 7]. Every product is an integer of magnitude <= 49, so while
// 49 * K < 2^24 every partial sum is an exact integer in float32 and the
// Pallas kernel's float32 accumulation equals an exact integer sum in any
// order. The kernel therefore carries the operands as int8 and accumulates
// in int32 with __dp4a (four byte products per instruction), converts once,
// and runs the epilogue in float32 in the reference's order (built with
// -fmad=false, IEEE sqrtf): its output equals the reference bit for bit. The
// wrapper rejects K past the limit. What bounds it on this card: at the
// serving shapes (M = 4 rows against the 151,936-column LM head, M = 256
// against 11,008) the int8 weight operand and the float32 output and noise
// dominate, so bytes; at M >= a few hundred rows the int8 products would be
// (1,979 T op/s on the tensor cores). This first version tiles 64 x 64
// outputs per block of 256 threads (4 x 4 per thread), stages 32-deep K
// slices of both operands in shared memory (B transposed so that each
// thread reads four consecutive k as one int), and masks the ragged M, N
// and K edges itself (zero bytes add nothing). Tensor cores (mma.sync s8 or
// wgmma) and TMA are later work.
//
// flash_attention_kernel: the online-softmax attention forward on
// (BH, S, D) with f32 running max m, denominator l and accumulator, scores
// s = (q . k) * scale (scale = f32(D^-0.5) multiplies the score), masked
// scores NEG_INF = -1e30, causal key tiles past the query tile skipped,
// l = l * corr + sum(p), acc = acc * corr + p @ v, out = acc / max(l, 1e-30)
// in q's dtype (f32 or bf16). GQA: query head row bh reads kv row
// bh / group (the reference's repeat of K/V, without the copy). What bounds
// it: 4 * BH * S^2 * D operations (halved when causal) against the Q/K/V/O
// bytes; at S = 4096, D = 128 the operations, by far. This first version
// runs on the CUDA cores in f32: one block of 4 warps per 32-query tile,
// each warp 8 query rows; K and V stream through shared memory 32 keys at a
// time (one key per lane for the scores, one output column per lane for
// p @ v); dot products use explicit fmaf on 128-bit shared loads. Scores on
// the tensor cores (wgmma over bf16 tiles) and TMA are later work. Any
// D <= 256: rows are zero-padded to a multiple of 4 in shared memory, and
// the K tile's row stride is chosen so that a quarter-warp's 128-bit loads
// hit distinct banks.
//
// Every entry point has a plain C interface (loaded with ctypes) and returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------- ddot ---

constexpr int kGemmBM = 64;
constexpr int kGemmBN = 64;
constexpr int kGemmBK = 32;
constexpr int kGemmThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kGemmPad = 4;        // bytes of row padding in shared memory

template <bool kNoise>
__global__ void __launch_bounds__(kGemmThreads)
    ddot_gemm_kernel(const int8_t* __restrict__ qa,
                     const int8_t* __restrict__ qb,
                     const float* __restrict__ sa,
                     const float* __restrict__ sb,
                     const float* __restrict__ z, float* __restrict__ out,
                     int m, int n, int k, float noise_rms) {
  __shared__ __align__(16) int8_t a_tile[kGemmBM][kGemmBK + kGemmPad];
  __shared__ __align__(16) int8_t b_tile[kGemmBN][kGemmBK + kGemmPad];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kGemmBM;
  const int n0 = blockIdx.x * kGemmBN;
  int acc[4][4];
  int pw[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0;
      pw[i][j] = 0;
    }
  }
  for (int k0 = 0; k0 < k; k0 += kGemmBK) {
    // A slice (64 rows x 32 k): consecutive threads read consecutive k.
    for (int e = tid; e < kGemmBM * kGemmBK; e += kGemmThreads) {
      const int r = e / kGemmBK;
      const int c = e % kGemmBK;
      const int gm = m0 + r;
      const int gk = k0 + c;
      a_tile[r][c] = (gm < m && gk < k)
                         ? qa[static_cast<size_t>(gm) * k + gk]
                         : static_cast<int8_t>(0);
    }
    // B slice (32 k x 64 columns): read along n, stored as (n, k).
    for (int e = tid; e < kGemmBK * kGemmBN; e += kGemmThreads) {
      const int r = e / kGemmBN;
      const int c = e % kGemmBN;
      const int gk = k0 + r;
      const int gn = n0 + c;
      b_tile[c][r] = (gk < k && gn < n)
                         ? qb[static_cast<size_t>(gk) * n + gn]
                         : static_cast<int8_t>(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGemmBK; kk += 4) {
      int a4[4];
      int b4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a4[i] = *reinterpret_cast<const int*>(&a_tile[ty + 16 * i][kk]);
        b4[i] = *reinterpret_cast<const int*>(&b_tile[tx + 16 * i][kk]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __dp4a(a4[i], b4[j], acc[i][j]);
        }
      }
      if (kNoise) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a4[i] = static_cast<int>(__vabs4(static_cast<unsigned>(a4[i])));
          b4[i] = static_cast<int>(__vabs4(static_cast<unsigned>(b4[i])));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pw[i][j] = __dp4a(a4[i], b4[j], pw[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
  // Epilogue in the reference's float32 order (no FMA contraction).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
    const float row_scale = sa[gm];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= n) continue;
      const size_t o = static_cast<size_t>(gm) * n + gn;
      float v = static_cast<float>(acc[i][j]);
      if (kNoise) {
        const float sd = noise_rms * sqrtf(static_cast<float>(pw[i][j]));
        v = v + sd * z[o];
      }
      out[o] = (v * row_scale) * sb[gn];
    }
  }
}

// ----------------------------------------------------- flash attention ---

constexpr int kFaRows = 8;                    // query rows per warp
constexpr int kFaWarps = 4;
constexpr int kFaThreads = 32 * kFaWarps;
constexpr int kFaBQ = kFaRows * kFaWarps;     // query rows per block
constexpr int kFaBK = 32;                     // keys per tile, one per lane
constexpr int kFaMaxD = 256;
constexpr int kFaCols = kFaMaxD / 32;         // output columns per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
  }
  return x;
}

// Shared-memory layout (floats) of one block for head dim d:
//   q tile  kFaBQ x dq  (dq = d rounded up to 4, zero-padded)
//   k tile  kFaBK x dk  (dk = dq, plus 4 when dq / 4 is even: dk / 4 odd)
//   p tile  kFaBQ x kFaBK
//   v tile  kFaBK x d   (last: the only tile read without float4 loads)
__host__ __device__ inline int fa_dq(int d) { return (d + 3) / 4 * 4; }
__host__ __device__ inline int fa_dk(int d) {
  const int dq = fa_dq(d);
  return (dq / 4) % 2 == 0 ? dq + 4 : dq;
}
inline size_t fa_smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(kFaBQ) * fa_dq(d) +
                          static_cast<size_t>(kFaBK) * fa_dk(d) +
                          static_cast<size_t>(kFaBK) * d + kFaBQ * kFaBK);
}

template <typename T>
__global__ void __launch_bounds__(kFaThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int sq, int skv, int d, int group, int causal,
                           float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dq = fa_dq(d);
  const int dk = fa_dk(d);
  float* qs = smem;
  float* ks = qs + kFaBQ * dq;
  float* ps = ks + kFaBK * dk;
  float* vs = ps + kFaBQ * kFaBK;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kFaBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * kFaRows;
  const T* qp = q + static_cast<size_t>(bh) * sq * d;
  const T* kp = k + static_cast<size_t>(bh / group) * skv * d;
  const T* vp = v + static_cast<size_t>(bh / group) * skv * d;

  // tiles load row by row, one warp per row, lanes along the row
  for (int r = warp; r < kFaBQ; r += kFaWarps) {
    const bool in = q0 + r < sq;
    const T* src = qp + static_cast<size_t>(q0 + r) * d;
    for (int c = lane; c < dq; c += 32) {
      qs[r * dq + c] = (in && c < d) ? to_f32(src[c]) : 0.0f;
    }
  }

  float m_run[kFaRows];
  float l_run[kFaRows];
  float acc[kFaRows][kFaCols];
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kFaCols; ++j) acc[r][j] = 0.0f;
  }

  int n_tiles = (skv + kFaBK - 1) / kFaBK;
  if (causal) {
    // key tiles that start past the block's last query row see only
    // masked scores (the reference's causal block skip)
    const int last = (q0 + kFaBQ - 1) / kFaBK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* ps4 = reinterpret_cast<const float4*>(ps);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kFaBK;
    __syncthreads();  // the previous tile's k, v and p are read
    for (int r = warp; r < kFaBK; r += kFaWarps) {
      const bool in = k0 + r < skv;
      const T* ksrc = kp + static_cast<size_t>(k0 + r) * d;
      const T* vsrc = vp + static_cast<size_t>(k0 + r) * d;
      for (int c = lane; c < dq; c += 32) {
        ks[r * dk + c] = (in && c < d) ? to_f32(ksrc[c]) : 0.0f;
      }
      for (int c = lane; c < d; c += 32) {
        vs[r * d + c] = in ? to_f32(vsrc[c]) : 0.0f;
      }
    }
    __syncthreads();

    // scores of this lane's key against the warp's rows
    float s[kFaRows];
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) s[r] = 0.0f;
    for (int c4 = 0; c4 < dq / 4; ++c4) {
      const float4 kv = ks4[lane * (dk / 4) + c4];
#pragma unroll
      for (int r = 0; r < kFaRows; ++r) {
        const float4 qv = qs4[(row0 + r) * (dq / 4) + c4];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    const int key = k0 + lane;
    float corr[kFaRows];
#pragma unroll
    for (int r = 0; r < kFaRows; ++r) {
      const int qpos = q0 + row0 + r;
      float x = s[r] * scale;
      if (key >= skv) {
        x = -INFINITY;  // past the keys: no weight at all
      } else if (causal && key > qpos) {
        x = kNegInf;
      }
      const float m_new = fmaxf(m_run[r], warp_max(x));
      const float p = expf(x - m_new);
      corr[r] = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * corr[r] + warp_sum(p);
      m_run[r] = m_new;
      ps[(row0 + r) * kFaBK + lane] = p;
    }
    __syncwarp();

    // acc = acc * corr + p @ v, one output column per lane and pass
#pragma unroll
    for (int j = 0; j < kFaCols; ++j) {
      const int col = lane + 32 * j;
      if (col < d) {
        float pv[kFaRows];
#pragma unroll
        for (int r = 0; r < kFaRows; ++r) pv[r] = 0.0f;
        for (int c4 = 0; c4 < kFaBK / 4; ++c4) {
          const float v0 = vs[(4 * c4 + 0) * d + col];
          const float v1 = vs[(4 * c4 + 1) * d + col];
          const float v2 = vs[(4 * c4 + 2) * d + col];
          const float v3 = vs[(4 * c4 + 3) * d + col];
#pragma unroll
          for (int r = 0; r < kFaRows; ++r) {
            const float4 p4 = ps4[(row0 + r) * (kFaBK / 4) + c4];
            pv[r] = fmaf(p4.x, v0, pv[r]);
            pv[r] = fmaf(p4.y, v1, pv[r]);
            pv[r] = fmaf(p4.z, v2, pv[r]);
            pv[r] = fmaf(p4.w, v3, pv[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < kFaRows; ++r) {
          acc[r][j] = acc[r][j] * corr[r] + pv[r];
        }
      }
    }
    __syncwarp();
  }

  T* op = out + static_cast<size_t>(bh) * sq * d;
#pragma unroll
  for (int r = 0; r < kFaRows; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l_run[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kFaCols; ++j) {
      const int col = lane + 32 * j;
      if (col < d) {
        from_f32(acc[r][j] / denom, op + static_cast<size_t>(qpos) * d + col);
      }
    }
  }
}

template <typename T>
int flash_attention_launch_t(const void* q, const void* k, const void* v,
                             void* out, int bh, int sq, int skv, int d,
                             int group, int causal, float scale,
                             cudaStream_t stream) {
  const size_t smem = fa_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kFaBQ - 1) / kFaBQ, bh);
  if (grid.x > 0 && bh > 0) {
    flash_attention_kernel<T><<<grid, kFaThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), sq, skv, d, group,
        causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ddot_gemm_launch(const int8_t* qa, const int8_t* qb, const float* sa,
                     const float* sb, const float* z, float* out, int m,
                     int n, int k, int with_noise, float noise_rms,
                     void* stream) {
  dim3 grid((n + kGemmBN - 1) / kGemmBN, (m + kGemmBM - 1) / kGemmBM);
  auto s = static_cast<cudaStream_t>(stream);
  if (m > 0 && n > 0) {
    if (with_noise) {
      ddot_gemm_kernel<true><<<grid, kGemmThreads, 0, s>>>(
          qa, qb, sa, sb, z, out, m, n, k, noise_rms);
    } else {
      ddot_gemm_kernel<false><<<grid, kGemmThreads, 0, s>>>(
          qa, qb, sa, sb, z, out, m, n, k, noise_rms);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int bh, int sq, int skv, int d,
                           int group, int causal, float scale, int is_bf16,
                           void* stream) {
  if (d < 1 || d > kFaMaxD || group < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return flash_attention_launch_t<__nv_bfloat16>(q, k, v, out, bh, sq, skv,
                                                   d, group, causal, scale, s);
  }
  return flash_attention_launch_t<float>(q, k, v, out, bh, sq, skv, d, group,
                                         causal, scale, s);
}

}  // extern "C"
