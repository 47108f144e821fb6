// Hopper (sm_90a) kernel of the LM path: the photonic DDot GEMM.
//
//   ddot_gemm_kernel <- src/repro/kernels/ddot_gemm.py
//                       ddot_gemm_quantized (_ddot_kernel)
//
// (The fused attention forward lives in csrc/flash_attention.cu, wgmma for
// bf16, and csrc/flash_attention_tf32.cu, mma.sync in TF32 for the rest.)
//
// ddot_gemm_kernel: out = ((acc [+ (noise_rms * sqrt(pow)) * z]) * sa) * sb
// with acc = qa @ qb and pow = |qa| @ |qb| over 4-bit integer operands in
// [-7, 7]. Every product is an integer of magnitude <= 49, so while
// 49 * K < 2^24 every partial sum is an exact integer in float32 and the
// Pallas kernel's float32 accumulation equals an exact integer sum in any
// order. The kernel therefore carries the operands as int8, multiplies on
// the tensor cores (mma.sync m16n8k32 s8 x s8 -> s32), converts once, and
// runs the epilogue in float32 in the reference's order (built with
// -fmad=false, IEEE sqrtf): its output equals the reference bit for bit.
// The noise power is a second mma on the same fragments made absolute with
// __vabsss4, so it loads no extra bytes. The wrapper rejects K past the
// limit. B arrives K-major, as (N, K): 8-bit mma operands are K-major only,
// and the LM head's transposed table quantizes to exactly that layout.
//
// What bounds it on this card: bytes. At the LM head (M = 4 rows against
// the 151,936-column table, K = 2048) the 311 MB int8 table is 0.093 ms at
// 3.35 TB/s against 0.003 ms of int8 operations; at the MLP shape (M = 256,
// N = 11,008) 22.5 MB of B and 11.3 MB each of f32 output and noise z, with
// the products (0.006 ms at 1,979 T op/s, about twice that on mma.sync)
// next to it. What the design does about it: 16-byte cp.async loads of A
// and B tiles into a 4-stage ring of 128-byte K stages in shared memory,
// rows padded to an odd number of 16-byte chunks so that ldmatrix reads
// them free of bank conflicts; zero-filled loads mask the ragged M, N and
// K edges (byte loads when K % 16 != 0 leaves the rows unaligned); the
// int32 sums staged in shared memory so that the epilogue reads z and
// writes the output 16 bytes a thread; the M tile chosen by M:
//   M <= 16: 16 x 128 outputs, 4 warps of 16 x 32, 4 x 20.7 KB of ring
//            (M = 4 loads zero rows past M, which cost no bytes);
//   M  > 16: 64 x 128 outputs, 8 warps of 32 x 32, 4 x 27.6 KB of ring,
// two blocks an SM, so that the head's 1,187 column tiles and the MLP
// shape's 4 x 86 tiles each cover the 132 SMs more than twice; blocks of
// one B column tile run side by side (M tiles fastest), so B is read from
// device memory once. ptxas: 66 registers a thread at M <= 16 (95 with
// noise), 97 above (128 with noise), no spills. Of the tile shapes tried
// on the card (M tile 16, 64 or 128 rows, N tile 64 to 256 columns, 64-
// or 128-byte stages, 3 to 6 stages, and an int8 wgmma version with one
// warpgroup a 64 x 128 tile), these two were the fastest at their shapes.
//
// Every entry point has a plain C interface (loaded with ctypes) and returns
// cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

// ---------------------------------------------------------------- ddot ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; the bytes past `bytes` (0..16) are zero.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, s32) += a (16 x 32, s8, row) * b (32 x 8, s8, col)
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// BM x BN outputs per block of WM x WN warps, BK bytes of K per stage,
// STAGES stages in the ring.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct GemmTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_;
  static constexpr int STAGES = STAGES_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kRow = BK + 16;  // an odd number of 16-byte chunks
  static constexpr int kStage = (BM + BN) * kRow;
  static constexpr int kEpiRow = BN + 4;  // int32 of a staged output row
  static constexpr int kEpi = 2 * BM * kEpiRow * 4;
  static constexpr int kSmem =
      STAGES * kStage > kEpi ? STAGES * kStage : kEpi;
  static constexpr int MI = BM / WM / 16;  // m16 tiles of a warp
  static constexpr int NI = BN / WN / 8;   // n8 tiles of a warp
  static_assert(NI % 2 == 0 && BK % 32 == 0, "tile shape");
};
using HeadTile = GemmTile<16, 128, 128, 1, 4, 4>;  // M <= 16
using WideTile = GemmTile<64, 128, 128, 2, 4, 4>;  // M > 16

// One ring stage: BM rows of A, then BN rows of B (K-major), BK bytes each
// from k0; rows past M or N and bytes past K are zero.
template <class T, bool kVec>
__device__ __forceinline__ void load_stage(uint32_t stage,
                                           const int8_t* __restrict__ qa,
                                           const int8_t* __restrict__ qbt,
                                           int m, int n, int k, int m0,
                                           int n0, int k0) {
  constexpr int kChunks = T::BK / 16;
  for (int i = threadIdx.x; i < (T::BM + T::BN) * kChunks;
       i += T::kThreads) {
    const int r = i / kChunks;
    const int kb = k0 + (i % kChunks) * 16;
    const bool is_a = r < T::BM;
    const int gr = is_a ? m0 + r : n0 + (r - T::BM);
    const int8_t* base = is_a ? qa : qbt;
    int bytes = k - kb;
    bytes = bytes < 0 ? 0 : (bytes > 16 ? 16 : bytes);
    if (gr >= (is_a ? m : n)) bytes = 0;
    const int8_t* src =
        bytes > 0 ? base + static_cast<size_t>(gr) * k + kb : base;
    const uint32_t dst = stage + r * T::kRow + (i % kChunks) * 16;
    if (kVec) {
      cp_async16(dst, src, bytes);
    } else {  // rows not 16-byte aligned: byte loads
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        if (b < bytes) {
          w[b / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[b]))
                      << (8 * (b % 4));
        }
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// The reference's float32 epilogue of one output (no FMA: -fmad=false).
template <bool kNoise>
__device__ __forceinline__ float ddot_out(int acc, int pw, float z,
                                          float noise_rms, float row_scale,
                                          float col_scale) {
  float v = static_cast<float>(acc);
  if (kNoise) {
    const float sd = noise_rms * sqrtf(static_cast<float>(pw));
    v = v + sd * z;
  }
  return (v * row_scale) * col_scale;
}

// qa (M, K) and qbt (N, K) int8, both K-major; sa (M), sb (N), z and out
// (M, N) float32. vec_out: N % 4 == 0 and sb, z, out 16-byte aligned.
template <class T, bool kNoise, bool kVec>
__global__ void __launch_bounds__(T::kThreads)
    ddot_gemm_kernel(const int8_t* __restrict__ qa,
                     const int8_t* __restrict__ qbt,
                     const float* __restrict__ sa,
                     const float* __restrict__ sb,
                     const float* __restrict__ z, float* __restrict__ out,
                     int m, int n, int k, float noise_rms, int vec_out) {
  extern __shared__ __align__(16) uint8_t gemm_smem[];
  const uint32_t ring = smem_u32(gemm_smem);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp / T::WN;
  const int wn = warp % T::WN;
  const int m0 = blockIdx.x * T::BM;  // M tiles fastest: one B tile's
  const int n0 = blockIdx.y * T::BN;  // blocks run side by side
  int acc[T::MI][T::NI][4];
  int pw[T::MI][T::NI][4];
#pragma unroll
  for (int i = 0; i < T::MI; ++i) {
#pragma unroll
    for (int j = 0; j < T::NI; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0;
        pw[i][j][e] = 0;
      }
    }
  }

  const int kt_n = (k + T::BK - 1) / T::BK;
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < kt_n) {
      load_stage<T, kVec>(ring + s * T::kStage, qa, qbt, m, n, k, m0, n0,
                          s * T::BK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is read by everyone
    const int next = kt + T::STAGES - 1;
    if (next < kt_n) {
      load_stage<T, kVec>(ring + (next % T::STAGES) * T::kStage, qa, qbt, m,
                          n, k, m0, n0, next * T::BK);
    }
    cp_async_commit();
    const uint32_t a_s = ring + (kt % T::STAGES) * T::kStage;
    const uint32_t b_s = a_s + T::BM * T::kRow;
#pragma unroll
    for (int ks = 0; ks < T::BK / 32; ++ks) {
      uint32_t a[T::MI][4];
      uint32_t b[T::NI][2];
#pragma unroll
      for (int i = 0; i < T::MI; ++i) {
        const int row = (wm * T::MI + i) * 16 + (lane & 15);
        ldmatrix_x4(a[i], a_s + row * T::kRow + ks * 32 + (lane >> 4) * 16);
      }
#pragma unroll
      for (int j = 0; j < T::NI / 2; ++j) {
        const int row = (wn * T::NI + 2 * j) * 8 + (lane & 7) +
                        ((lane >> 4) << 3);
        uint32_t r[4];
        ldmatrix_x4(r, b_s + row * T::kRow + ks * 32 +
                           ((lane >> 3) & 1) * 16);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < T::MI; ++i) {
#pragma unroll
        for (int j = 0; j < T::NI; ++j) mma_s8(acc[i][j], a[i], b[j]);
      }
      if (kNoise) {
#pragma unroll
        for (int i = 0; i < T::MI; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[i][e] = __vabsss4(a[i][e]);
        }
#pragma unroll
        for (int j = 0; j < T::NI; ++j) {
          b[j][0] = __vabsss4(b[j][0]);
          b[j][1] = __vabsss4(b[j][1]);
        }
#pragma unroll
        for (int i = 0; i < T::MI; ++i) {
#pragma unroll
          for (int j = 0; j < T::NI; ++j) mma_s8(pw[i][j], a[i], b[j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the sums over it

  int* epi = reinterpret_cast<int*>(gemm_smem);
  int* epi_pw = epi + T::BM * T::kEpiRow;
#pragma unroll
  for (int i = 0; i < T::MI; ++i) {
#pragma unroll
    for (int j = 0; j < T::NI; ++j) {
      const int row = (wm * T::MI + i) * 16 + lane / 4;
      const int col = (wn * T::NI + j) * 8 + 2 * (lane % 4);
      const int o0 = row * T::kEpiRow + col;
      const int o1 = o0 + 8 * T::kEpiRow;
      *reinterpret_cast<int2*>(epi + o0) =
          make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(epi + o1) =
          make_int2(acc[i][j][2], acc[i][j][3]);
      if (kNoise) {
        *reinterpret_cast<int2*>(epi_pw + o0) =
            make_int2(pw[i][j][0], pw[i][j][1]);
        *reinterpret_cast<int2*>(epi_pw + o1) =
            make_int2(pw[i][j][2], pw[i][j][3]);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < T::BM * T::BN / 4; i += T::kThreads) {
    const int r = i / (T::BN / 4);
    const int c = (i % (T::BN / 4)) * 4;
    const int gm = m0 + r;
    const int gn = n0 + c;
    if (gm >= m || gn >= n) continue;
    const float row_scale = sa[gm];
    const int4 av = *reinterpret_cast<const int4*>(epi + r * T::kEpiRow + c);
    const int4 pv = kNoise ? *reinterpret_cast<const int4*>(
                                 epi_pw + r * T::kEpiRow + c)
                           : make_int4(0, 0, 0, 0);
    const size_t o = static_cast<size_t>(gm) * n + gn;
    if (vec_out && gn + 3 < n) {
      const float4 sv = *reinterpret_cast<const float4*>(sb + gn);
      const float4 zv = kNoise ? *reinterpret_cast<const float4*>(z + o)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 res;
      res.x = ddot_out<kNoise>(av.x, pv.x, zv.x, noise_rms, row_scale, sv.x);
      res.y = ddot_out<kNoise>(av.y, pv.y, zv.y, noise_rms, row_scale, sv.y);
      res.z = ddot_out<kNoise>(av.z, pv.z, zv.z, noise_rms, row_scale, sv.z);
      res.w = ddot_out<kNoise>(av.w, pv.w, zv.w, noise_rms, row_scale, sv.w);
      *reinterpret_cast<float4*>(out + o) = res;
    } else {
      const int a4[4] = {av.x, av.y, av.z, av.w};
      const int p4[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (gn + e < n) {
          out[o + e] = ddot_out<kNoise>(a4[e], p4[e], kNoise ? z[o + e] : 0.f,
                                        noise_rms, row_scale, sb[gn + e]);
        }
      }
    }
  }
}

template <class T, bool kNoise, bool kVec>
int ddot_launch_t(const int8_t* qa, const int8_t* qbt, const float* sa,
                  const float* sb, const float* z, float* out, int m, int n,
                  int k, float noise_rms, int vec_out, cudaStream_t stream) {
  auto kernel = ddot_gemm_kernel<T, kNoise, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + T::BM - 1) / T::BM, (n + T::BN - 1) / T::BN);
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(qa, qbt, sa, sb, z, out, m,
                                                   n, k, noise_rms, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int ddot_dispatch(const int8_t* qa, const int8_t* qbt, const float* sa,
                  const float* sb, const float* z, float* out, int m, int n,
                  int k, bool noise, float noise_rms, bool vec_k, int vec_out,
                  cudaStream_t s) {
  if (noise) {
    return vec_k ? ddot_launch_t<T, true, true>(qa, qbt, sa, sb, z, out, m, n,
                                                k, noise_rms, vec_out, s)
                 : ddot_launch_t<T, true, false>(qa, qbt, sa, sb, z, out, m,
                                                 n, k, noise_rms, vec_out, s);
  }
  return vec_k ? ddot_launch_t<T, false, true>(qa, qbt, sa, sb, z, out, m, n,
                                               k, noise_rms, vec_out, s)
               : ddot_launch_t<T, false, false>(qa, qbt, sa, sb, z, out, m, n,
                                                k, noise_rms, vec_out, s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// qa (m, k) and qbt (n, k) int8, K-major; sa (m), sb (n), z (read only
// with noise) and out (m, n) float32; all contiguous.
int ddot_gemm_launch(const int8_t* qa, const int8_t* qbt, const float* sa,
                     const float* sb, const float* z, float* out, int m,
                     int n, int k, int with_noise, float noise_rms,
                     void* stream) {
  if (m <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  const bool noise = with_noise != 0;
  const bool vec_k = k % 16 == 0 && aligned16(qa) && aligned16(qbt);
  const int vec_out = n % 4 == 0 && aligned16(sb) && aligned16(out) &&
                      (!noise || aligned16(z));
  if (m <= HeadTile::BM) {
    return ddot_dispatch<HeadTile>(qa, qbt, sa, sb, z, out, m, n, k, noise,
                                   noise_rms, vec_k, vec_out, s);
  }
  return ddot_dispatch<WideTile>(qa, qbt, sa, sb, z, out, m, n, k, noise,
                                 noise_rms, vec_k, vec_out, s);
}

}  // extern "C"
