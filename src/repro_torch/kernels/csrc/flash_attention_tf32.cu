// Hopper (sm_90a) kernel of the fused attention forward on the tensor cores
// in TF32 (mma.sync), for f32 inputs and for bf16 with D % 8 != 0.
//
//   flash_attention_tf32_kernel <- src/repro/kernels/flash_attention.py
//                                  flash_attention_bhsd (_flash_kernel)
//
// It computes the reference's online softmax: f32 running max m,
// correction and denominator l, s = (q . k) * scale (scale = f32(D^-0.5)),
// masked scores NEG_INF = -1e30, keys past the end -inf, causal key tiles
// past the query tile skipped, out = acc / max(l, 1e-30) in q's dtype.
// GQA: query head row bh reads KV row bh / group. bf16 with D % 8 == 0
// runs csrc/flash_attention.cu (wgmma + TMA) instead.
//
// Precision. One TF32 product keeps 10 mantissa bits of each operand and
// misses the f32 tolerance of 2e-5 by about 100x. For f32 operands every
// product is therefore taken in three TF32 passes (3xTF32): x = hi + lo
// with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (x - hi is exact
// in f32), and a . b ~ a_lo . b_hi + a_hi . b_lo + a_hi . b_hi, the small
// terms first into the f32 accumulator; only a_lo . b_lo (~2^-22 relative)
// is dropped. P stays f32 and is split the same way. bf16 operands are
// exact in TF32, so the bf16 instance takes one pass (P then rounds to
// TF32, well inside the bf16 tolerance of 2e-2).
//
// What bounds it on this card: 4 * BH * S^2 * D operations (halved when
// causal) against (2 BH + 2 BH / group) * S * D * 4 bytes; at the shapes
// it serves (S of a few hundred) the operations by far, but they are few:
// at BH 4, S 256, D 128 the whole call is 134 M operations, under 2 us of
// the card's f32 rate. What holds a kernel back at that size is filling
// 132 SMs and the latency of each warp's serial chain. The design:
//   * each warp owns 16 query rows (the m16 of mma.m16n8k8), four warps a
//     64-row block; a row's scores live in one quad of the C fragment, so
//     its max and sum take two __shfl_xor_sync steps;
//   * Q . K^T: Q (A, row-major) and K (B, "col": read straight from K's
//     rows, k = D) come from shared memory; P . V: P is the score
//     accumulator itself (A), with the keys of each k8 step permuted so
//     that the C fragment's (2t, 2t + 1) columns are the A fragment's
//     (t, t + 4) columns, and V (B) is read from its rows with the same
//     permutation, so no shuffle moves P;
//   * D is zero-padded in shared memory to its class DP, the next multiple
//     of 32 (one template instance per class), so that the fragment loops
//     run a fixed count with no branch: a run-time bound on them splits
//     the unrolled products into one basic block per step and serializes
//     each step's dependent mma chain;
//   * rows of Q, K and V sit in shared memory at a stride of DP + 4 floats
//     (4 mod 32 words), so that both fragment patterns (8 rows x 4 columns
//     for Q and K, 4 row pairs x 8 columns for V) hit 32 distinct banks;
//   * K and V tiles of kBK = 32 keys stream through a two-stage cp.async
//     ring: the next tile loads while this one computes (16-byte copies
//     where rows are 16-byte aligned, else 4-byte; bf16 tiles are
//     converted to f32 by plain loads). Two stages of 64 keys would take
//     169 KB at DP 128, one CTA of four warps an SM; 32 keys take 101 KB,
//     two CTAs;
//   * when the (query block, head) grid is smaller than the CTAs the card
//     holds at once, the keys are split across `splits` CTAs per block
//     (each a contiguous run of key tiles); each writes its unnormalized
//     (acc, m, l) to a scratch buffer and a second small kernel merges
//     them, l = sum l_s e^(m_s - m), acc likewise, in the same call. The
//     wrapper chooses `splits` and allocates the scratch.
// Shared memory: 4 * (DP + 4) * (64 + 4 kBK) bytes: 101 KB at DP 128, 200
// KB at DP 256. Built without -fmad=false: attention is held to a
// tolerance, not to bits.
//
// Every entry point has a plain C interface (loaded with ctypes) and
// returns a CUDA error code: the launch's, or cudaErrorInvalidValue for
// operands it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kBK = 32;           // keys per K/V tile
constexpr int kMaxD = 256;
constexpr int kMaxSplits = 64;
constexpr float kNegInf = -1e30f;

// Head-dim class DP (the width of the fragment loops: d rounded up to 32)
// and the row stride (floats) of a tile in shared memory.
__host__ __device__ constexpr int d_class(int d) { return (d + 31) / 32 * 32; }
__host__ __device__ constexpr int tile_ld(int dp) { return dp + 4; }

size_t smem_bytes(int d) {
  return sizeof(float) * static_cast<size_t>(tile_ld(d_class(d))) *
         (kBQ + 4 * kBK);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (cg) or 4 (ca) bytes; the bytes past `bytes` are zero.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in TF32 (kSplit), or hi alone.
template <bool kSplit, int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = to_tf32(x[i]);
    if (kSplit) lo[i] = to_tf32(x[i] - __uint_as_float(hi[i]));
  }
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in 3xTF32 (small terms first) or one pass.
template <bool kSplit>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (kSplit) {
    mma_tf32(c, al, bh);
    mma_tf32(c, ah, bl);
  }
  mma_tf32(c, ah, bh);
}

// Rows [row0, row0 + rows) of a (n_rows, d) matrix into shared memory at
// stride ld, columns [0, d); rows past n_rows are zero. f32 goes by
// cp.async (16-byte copies when `vec`), bf16 by plain loads converted to
// f32. One warp a row, lanes along it.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int rows, int n_rows,
                                          int d, int ld, bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const bool in = row0 + r < n_rows;
    const float* s = src + static_cast<size_t>(in ? row0 + r : 0) * d;
    const uint32_t drow = smem_u32(dst + r * ld);
    if (vec) {
      for (int c = lane * 4; c < d; c += 128) {
        cp_async16(drow + 4 * c, s + c, in ? 16 : 0);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        cp_async4(drow + 4 * c, s + c, in ? 4 : 0);
      }
    }
  }
}
__device__ __forceinline__ void load_rows(float* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int n_rows, int d,
                                          int ld, bool) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    const bool in = row0 + r < n_rows;
    const __nv_bfloat16* s = src + static_cast<size_t>(row0 + r) * d;
    for (int c = lane; c < d; c += 32) {
      dst[r * ld + c] = in ? __bfloat162float(s[c]) : 0.0f;
    }
  }
}

__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}

// One CTA: 64 query rows of head bh against key tiles [t0, t1) of its
// split. splits == 1 writes the output; otherwise the partial
// (acc, m, l) go to `part`: acc at ((split * bh_n + bh) * sq + row) * dpad
// + col, then (m, l) per row after all the acc rows.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_tf32_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v, T* __restrict__ out,
                                float* __restrict__ part, int sq, int skv,
                                int d, int group, int causal, float scale,
                                int vec) {
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int NT = kBK / 8;  // n8 tiles of a score row, k8 steps of P.V
  constexpr int ND = DP / 8;  // k8 steps of Q . K^T = n8 tiles of the output
  extern __shared__ __align__(16) float smem[];
  constexpr int ld = tile_ld(DP);
  const int d8 = (d + 7) / 8;
  float* qs = smem;
  float* kv = qs + kBQ * ld;  // stage s: K at kv + 2 s kBK ld, V after it
  const int bh = blockIdx.y;
  const int bh_n = gridDim.y;
  const int splits = gridDim.z;
  const int split = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const T* qp = q + static_cast<size_t>(bh) * sq * d;
  const T* kp = k + static_cast<size_t>(bh / group) * skv * d;
  const T* vp = v + static_cast<size_t>(bh / group) * skv * d;

  int n_tiles = (skv + kBK - 1) / kBK;
  if (causal) {
    // key tiles that start past the block's last query row see only
    // masked scores (the reference's causal block skip)
    const int last = (q0 + kBQ - 1) / kBK + 1;
    n_tiles = n_tiles < last ? n_tiles : last;
  }
  const int per = (n_tiles + splits - 1) / splits;
  const int t0 = split * per;
  const int t1 = min(n_tiles, t0 + per);

  if (t0 < t1) {
    // zero the padded columns [d, DP) once: no load writes them
    if (d < DP) {
      for (int r = threadIdx.x; r < kBQ + 4 * kBK; r += kThreads) {
        for (int c = d; c < DP; ++c) qs[r * ld + c] = 0.0f;
      }
    }
    load_rows(qs, qp, q0, kBQ, sq, d, ld, vec);
    load_rows(kv, kp, t0 * kBK, kBK, skv, d, ld, vec);
    load_rows(kv + kBK * ld, vp, t0 * kBK, kBK, skv, d, ld, vec);
    cp_async_commit();
  }

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  }
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.0f, 0.0f};
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: a, a + 8
  const float* qw = qs + warp * 16 * ld;

  for (int it = t0; it < t1; ++it) {
    const int st = (it - t0) & 1;
    if (it + 1 < t1) {
      float* nk = kv + (st ^ 1) * 2 * kBK * ld;
      load_rows(nk, kp, (it + 1) * kBK, kBK, skv, d, ld, vec);
      load_rows(nk + kBK * ld, vp, (it + 1) * kBK, kBK, skv, d, ld, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // tile it landed (and every thread's plain stores)
    const float* ks = kv + st * 2 * kBK * ld;
    const float* vs = ks + kBK * ld;

    // S = Q . K^T
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      const int c = kk * 8 + t;
      const float a[4] = {qw[g * ld + c], qw[(g + 8) * ld + c],
                          qw[g * ld + c + 4], qw[(g + 8) * ld + c + 4]};
      uint32_t ah[4], al[4];
      split_tf32<kSplit>(a, ah, al);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float* kr = ks + (n * 8 + g) * ld + c;
        const float b[2] = {kr[0], kr[4]};
        uint32_t bhi[2], blo[2];
        split_tf32<kSplit>(b, bhi, blo);
        mma3<kSplit>(s[n], ah, al, bhi, blo);
      }
    }

    // online softmax; thread holds rows a (e = 0, 1) and a + 8 (e = 2, 3)
    const int k0 = it * kBK;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int row = row_a + 8 * (e >> 1);
        float x = s[n][e] * scale;
        if (key >= skv) {
          x = -INFINITY;  // past the keys: no weight at all
        } else if (causal && key > row) {
          x = kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m_run[i] - mx[i]);
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - mx[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l_run[i] = l_run[i] * corr[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P . V: k index t <-> key 2t, t + 4 <-> key 2t + 1 of each step
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      uint32_t ah[4], al[4];
      split_tf32<kSplit>(a, ah, al);
      const float* vr = vs + (kk * 8 + 2 * t) * ld + g;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float b[2] = {vr[n * 8], vr[ld + n * 8]};
        uint32_t bhi[2], blo[2];
        split_tf32<kSplit>(b, bhi, blo);
        mma3<kSplit>(o[n], ah, al, bhi, blo);
      }
    }
    __syncthreads();  // everyone is done with stage st before its reload
  }

  const size_t rows_n = static_cast<size_t>(bh_n) * sq;
  const int dpad = 8 * d8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= sq) continue;
    if (splits == 1) {
      const float denom = fmaxf(l_run[i], 1e-30f);
      T* orow = out + (static_cast<size_t>(bh) * sq + row) * d;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n * 8 + 2 * t + j;
          if (n < d8 && col < d) store(o[n][2 * i + j] / denom, orow + col);
        }
      }
    } else {
      const size_t r = static_cast<size_t>(split) * rows_n +
                       static_cast<size_t>(bh) * sq + row;
      float* arow = part + r * dpad;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n * 8 + 2 * t + j;
          if (n < d8) arow[col] = o[n][2 * i + j];
        }
      }
      if (t == 0) {
        float* ml = part + static_cast<size_t>(splits) * rows_n * dpad + 2 * r;
        // a split with no key tile holds nothing: m = -inf marks it
        ml[0] = t0 < t1 ? m_run[i] : -INFINITY;
        ml[1] = l_run[i];
      }
    }
  }
}

// out[row, col] from the splits' partials: m = max m_s, l = sum l_s
// e^(m_s - m), acc likewise, out = acc / max(l, 1e-30). Splits with no key
// tile (m_s = -inf) are skipped; split 0 always holds key tile 0, which no
// row masks entirely, so m is finite.
template <typename T>
__global__ void flash_attention_tf32_merge(const float* __restrict__ part,
                                           T* __restrict__ out, int rows_n,
                                           int d, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows_n * d) return;
  const int row = i / d;
  const int col = i - row * d;
  const int dpad = (d + 7) / 8 * 8;
  const float* ml = part + static_cast<size_t>(splits) * rows_n * dpad;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) {
    m = fmaxf(m, ml[2 * (static_cast<size_t>(s) * rows_n + row)]);
  }
  float l = 0.0f, acc = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const size_t r = static_cast<size_t>(s) * rows_n + row;
    const float ms = ml[2 * r];
    if (ms == -INFINITY) continue;
    const float w = expf(ms - m);
    l += ml[2 * r + 1] * w;
    acc += part[r * dpad + col] * w;
  }
  store(acc / fmaxf(l, 1e-30f), out + static_cast<size_t>(row) * d + col);
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part, int bh, int sq, int skv, int d, int group,
           int causal, float scale, int splits, cudaStream_t stream) {
  auto kernel = flash_attention_tf32_kernel<T, DP>;
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = d % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15u) == 0;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), part, sq, skv, d,
      group, causal, scale, vec ? 1 : 0);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int n = bh * sq * d;
  flash_attention_tf32_merge<T><<<(n + 255) / 256, 256, 0, stream>>>(
      part, static_cast<T*>(out), bh * sq, d, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* part, int bh, int sq, int skv, int d, int group,
             int causal, float scale, int splits, cudaStream_t s) {
#define FA_TF32_CLASS(DP)                                                    \
  case DP:                                                                   \
    return launch<T, DP>(q, k, v, out, part, bh, sq, skv, d, group, causal,  \
                         scale, splits, s);
  switch (d_class(d)) {
    FA_TF32_CLASS(32)
    FA_TF32_CLASS(64)
    FA_TF32_CLASS(96)
    FA_TF32_CLASS(128)
    FA_TF32_CLASS(160)
    FA_TF32_CLASS(192)
    FA_TF32_CLASS(224)
    FA_TF32_CLASS(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_TF32_CLASS
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) a block of the kernel takes at head dim d.
int flash_attention_tf32_smem_bytes(int d) {
  return d < 1 || d > kMaxD ? 0 : static_cast<int>(smem_bytes(d));
}

// q (bh, sq, d), k and v (bh / group, skv, d), out (bh, sq, d), all f32 or
// all bf16 (is_bf16) and contiguous, 1 <= d <= 256. With splits > 1, the
// keys are split across that many CTAs per query block and part is f32
// scratch of splits * bh * sq * (round8(d) + 2) floats.
int flash_attention_tf32_launch(const void* q, const void* k, const void* v,
                                void* out, int bh, int sq, int skv, int d,
                                int group, int causal, float scale,
                                int is_bf16, int splits, void* part,
                                void* stream) {
  if (d < 1 || d > kMaxD || group < 1 || bh % group != 0 || skv < 1 ||
      splits < 1 || splits > kMaxSplits || (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<float*>(part);
  if (is_bf16) {
    return dispatch<__nv_bfloat16>(q, k, v, out, p, bh, sq, skv, d, group,
                                   causal, scale, splits, s);
  }
  return dispatch<float>(q, k, v, out, p, bh, sq, skv, d, group, causal,
                         scale, splits, s);
}

}  // extern "C"
