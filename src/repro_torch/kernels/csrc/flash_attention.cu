// Hopper (sm_90a) kernel of the fused attention forward in bf16, on the
// tensor cores (wgmma) with K/V streamed by TMA.
//
//   flash_attention_wgmma_kernel <- src/repro/kernels/flash_attention.py
//                                   flash_attention_bhsd (_flash_kernel)
//
// It computes what csrc/flash_attention_tf32.cu's kernel computes
// (the reference's online softmax: f32 running max m, correction and
// denominator l, s = (q . k) * scale, masked scores NEG_INF = -1e30, keys
// past the end -inf, causal key tiles past the query tile skipped,
// out = acc / max(l, 1e-30)) for bf16 q, k, v with D % 8 == 0, D <= 256;
// GQA reads KV head bh / group. One rounding differs: P is rounded to bf16
// before P . V (the tensor cores take bf16 operands), about 2^-9 relative
// on each weight, inside the reference's bf16 tolerance of 2e-2. f32 inputs
// and other head dims run the TF32 kernel.
//
// What bounds it on this card: 4 * BH * S^2 * D operations (halved when
// causal) against (2 BH + 2 BH / group) * S * D * 2 bytes; at qwen2.5-3b's
// attention (BH 16, S 4096, D 128) 68.7 G operations, 0.0695 ms at the
// 989 T op/s bf16 rate, against 42 MB or 0.0125 ms of bytes: operations.
//
// What the design does about it (FlashAttention-3's shape, simplified):
//   * one CTA per (query head, 128-row Q tile): two consumer warpgroups of
//     64 query rows each and one producer warp, 288 threads; ptxas caps a
//     thread at 168 registers (it sizes a wgmma kernel in whole
//     warpgroups: 65,536 / 384), which hold the BK / 2 score and DP / 2
//     output accumulators without spills at DP <= 128 (DP = 256 spills a
//     little; setmaxnreg, tried, did not raise the cap);
//   * the producer loads the Q tile once and streams K and V tiles through
//     a two-stage ring in shared memory with TMA (128-byte swizzle, each
//     64-column slab of the head dim one box) and mbarriers (full: the
//     bytes landed; empty: both warpgroups are done with the stage), K and
//     V on separate barriers so that Q . K^T starts before V lands;
//   * S = Q . K^T is wgmma m64nBKk16 with both operands K-major in shared
//     memory; the softmax runs on the accumulator registers, row maxima
//     and sums reduced across the four lanes of a quad with shuffles;
//     P . V is wgmma m64nDPk16 with P (bf16, converted from the score
//     accumulator in registers) as the A operand and V in shared memory
//     through the transpose bit;
//   * the head dim is zero-filled by TMA up to DP, a multiple of 64 (the
//     swizzle's 128-byte row); the key tile BK is set per class:
//       DP  64 (D <= 64):  BK 128, 16 KB Q + 2 x 32 KB K/V =  80 KB;
//       DP 128 (D <= 128): BK 128, 32 KB Q + 2 x 64 KB K/V = 160 KB;
//       DP 256 (D <= 256): BK  64, 64 KB Q + 2 x 64 KB K/V = 192 KB,
//     since 128 keys of two-stage K and V at DP 256 (256 KB) exceed the
//     227 KB a block may hold; plus 1 KB for the 1024-byte alignment the
//     swizzle wants;
//   * the causal mask is applied only on tiles that cross the diagonal or
//     the key end; tiles past a warpgroup's last row are skipped;
//   * the grid runs the heaviest causal Q tiles first (reverse tile
//     order), the query heads of one KV head next to each other so that
//     they share K/V in L2.
// The tensor maps are built on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (no -lcuda), and passed as
// __grid_constant__ parameters. Built without -fmad=false: attention is
// held to a tolerance, not to bits.
//
// The entry point has a plain C interface (loaded with ctypes) and returns
// a CUDA error code: the launch's, or cudaErrorInvalidValue for operands
// it does not take.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 128;                    // query rows per CTA
constexpr int kConsumerThreads = 256;       // two warpgroups
constexpr int kThreads = kConsumerThreads + 32;  // and the producer warp
constexpr int kSlab = 64;                   // bf16 columns per 128-byte row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Key tile per head-dim class DP (see the note above).
template <int DP>
struct KeyTile {
  static constexpr int value = DP > 128 ? 64 : 128;
};

template <int DP>
constexpr int smem_bytes() {
  return 2 * DP * (kBQ + 4 * KeyTile<DP>::value) + 1024;
}

// ------------------------------------------------------------- PTX ---

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of `bar` with this parity to complete. A wait that
// never ends (a fault in the pipeline) traps after ~2^24 tries, so the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}

// One box of a 3-D tensor map (column, row, head) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64) = [d +] A (64 x 16) * B (16 x 64), A and B in shared memory,
// both K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 128) = [d +] A (64 x 16) * B (16 x 128), A and B in shared memory,
// both K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16) * B (16 x 64), A in registers, B in shared
// memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128) += A (64 x 16) * B (16 x 128), A in registers, B in shared
// memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 256) += A (64 x 16) * B (16 x 256), A in registers, B in shared
// memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_ss_n128(d, desc_a, desc_b, scale_d);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t desc_b) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, desc_b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, desc_b);
  } else {
    wgmma_rs_n256(d, a, desc_b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------- kernel ---

// Shared memory (from a 1024-byte aligned base): Q, DP / 64 slabs of
// 128 rows x 128 bytes; K stages 0 and 1, then V stages 0 and 1, each
// DP / 64 slabs of BK rows x 128 bytes; every slab 128-byte swizzled by TMA.
// Accumulator layout of wgmma m64nN (a warpgroup's 64 rows): the thread of
// warp w, lane l holds rows 16 w + l / 4 and 16 w + l / 4 + 8, columns
// 8 j + 2 (l % 4) + {0, 1} in registers 4 j + {0, 1} and 4 j + {2, 3}.
template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 __nv_bfloat16* __restrict__ out, int bh_count,
                                 int sq, int skv, int d, int group, int causal,
                                 float scale) {
  constexpr int BK = KeyTile<DP>::value;
  constexpr int kSlabs = DP / kSlab;
  constexpr int kQBytes = kBQ * DP * 2;
  constexpr int kKVBytes = BK * DP * 2;  // one stage of K or of V
  constexpr int NS = BK / 2;             // score registers a thread
  constexpr int NO = DP / 2;             // output registers a thread

  extern __shared__ uint8_t smem_raw[];
  // q; full K, full V and empty of stage 0, then of stage 1
  __shared__ __align__(8) uint64_t bars[7];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + kQBytes;
  const uint32_t v_s = k_s + 2 * kKVBytes;
  const uint32_t bar_q = smem_u32(&bars[0]);
  auto full_k = [&](int s) { return smem_u32(&bars[1 + 3 * s]); };
  auto full_v = [&](int s) { return smem_u32(&bars[2 + 3 * s]); };
  auto empty = [&](int s) { return smem_u32(&bars[3 + 3 * s]); };

  // heaviest causal tiles first; the query heads of a KV head side by side
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / bh_count) * kBQ;
  const int kvh = bh / group;
  int n_tiles = (skv + BK - 1) / BK;
  if (causal) {
    const int last = (q0 + kBQ - 1) / BK + 1;  // the reference's block skip
    n_tiles = n_tiles < last ? n_tiles : last;
  }

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {  // the producer warp; one lane issues
    if (tid == kConsumerThreads) {
      mbar_expect_tx(bar_q, kQBytes);
      for (int c = 0; c < kSlabs; ++c) {
        tma_load(q_s + c * kBQ * 128, &tm_q, bar_q, c * kSlab, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t & 1;
        if (t >= 2) mbar_wait(empty(s), ((t >> 1) - 1) & 1);
        const uint32_t ks = k_s + s * kKVBytes;
        const uint32_t vs = v_s + s * kKVBytes;
        mbar_expect_tx(full_k(s), kKVBytes);
        for (int c = 0; c < kSlabs; ++c) {
          tma_load(ks + c * BK * 128, &tm_k, full_k(s), c * kSlab, t * BK,
                   kvh);
        }
        mbar_expect_tx(full_v(s), kKVBytes);
        for (int c = 0; c < kSlabs; ++c) {
          tma_load(vs + c * BK * 128, &tm_v, full_v(s), c * kSlab, t * BK,
                   kvh);
        }
      }
    }
    return;  // no block-wide barrier follows
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int quad = lane % 4;
  const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;  // and row0 + 8
  const int wg_first = q0 + wg * 64;

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows row0, row0 + 8
  float l0 = 0.0f, l1 = 0.0f;        // this lane's part of the denominators

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    const uint32_t parity = (t >> 1) & 1;
    const int k0 = t * BK;
    mbar_wait(full_k(s), parity);
    if (causal && k0 > wg_first + 63) {  // every key past this group's rows
      mbar_arrive(empty(s));
      continue;
    }

    // S = Q . K^T (64 x BK per warpgroup)
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.0f;
    fence_regs<NS>(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {  // zero columns past D add 0
      const uint32_t qa = q_s + (kk / 4) * (kBQ * 128) + wg * (64 * 128) +
                          (kk % 4) * 32;
      const uint32_t kb =
          k_s + s * kKVBytes + (kk / 4) * (BK * 128) + (kk % 4) * 32;
      wgmma_ss<BK>(sc, sw128_desc(qa, 16, 1024), sw128_desc(kb, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NS>(sc);

    // s = acc * scale, masked on tiles that cross the diagonal or the end
    const bool edge =
        k0 + BK > skv || (causal && k0 + BK - 1 > wg_first);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale;
        if (edge) {
          const int key = k0 + 8 * j + 2 * quad + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= skv) {
            x = -INFINITY;  // past the keys: no weight at all
          } else if (causal && key > row) {
            x = kNegInf;
          }
        }
        sc[4 * j + e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    const float corr0 = exp2f((m0 - mx0) * kLog2e);
    const float corr1 = exp2f((m1 - mx1) * kLog2e);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = exp2f((sc[4 * j] - mx0) * kLog2e);
      sc[4 * j + 1] = exp2f((sc[4 * j + 1] - mx0) * kLog2e);
      sc[4 * j + 2] = exp2f((sc[4 * j + 2] - mx1) * kLog2e);
      sc[4 * j + 3] = exp2f((sc[4 * j + 3] - mx1) * kLog2e);
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
    // P (bf16) as wgmma A fragments: k16 step kk is score columns
    // 16 kk .. 16 kk + 15, i.e. n8 blocks 2 kk and 2 kk + 1
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P . V (64 x DP per warpgroup), V read MN-major
    mbar_wait(full_v(s), parity);
    fence_regs<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t vb = v_s + s * kKVBytes + kk * 16 * 128;
      wgmma_rs<DP>(o, pa[kk], sw128_desc(vb, BK * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NO>(o);
    mbar_arrive(empty(s));
  }

  const float den0 = fmaxf(quad_sum(l0), 1e-30f);
  const float den1 = fmaxf(quad_sum(l1), 1e-30f);
  __nv_bfloat16* orow = out + (static_cast<size_t>(bh) * sq + row0) * d;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * quad;
    if (col < d) {
      if (row0 < sq) {
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[4 * j] / den0, o[4 * j + 1] / den0);
      }
      if (row0 + 8 < sq) {
        *reinterpret_cast<uint32_t*>(orow + 8 * d + col) =
            pack_bf16(o[4 * j + 2] / den1, o[4 * j + 3] / den1);
      }
    }
  }
}

// ------------------------------------------------------------ host ---

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// Tensor map of a (heads, rows, d) bf16 tensor, boxes of 64 columns x
// box_rows rows of one head, 128-byte swizzle, zero fill past every edge.
bool make_map(CUtensorMap* map, const void* ptr, int heads, int rows, int d,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {kSlab, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int skv, int d, int group, int causal, float scale,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, bh, sq, d, kBQ) ||
      !make_map(&tk, k, bh / group, skv, d, KeyTile<DP>::value) ||
      !make_map(&tv, v, bh / group, skv, d, KeyTile<DP>::value)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<DP>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((sq + kBQ - 1) / kBQ) * bh);
  flash_attention_wgmma_kernel<DP><<<grid, kThreads, smem_bytes<DP>(),
                                     stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), bh, sq, skv, d, group,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// q (bh, sq, d), k and v (bh / group, skv, d), out (bh, sq, d), all bf16
// and contiguous, 16-byte aligned, d % 8 == 0 and d <= 256.
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                 void* out, int bh, int sq, int skv, int d,
                                 int group, int causal, float scale,
                                 void* stream) {
  if (d < 8 || d > 256 || d % 8 != 0 || group < 1 || bh % group != 0 ||
      skv < 1 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || sq == 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (d <= 64) {
    return launch<64>(q, k, v, out, bh, sq, skv, d, group, causal, scale, s);
  }
  if (d <= 128) {
    return launch<128>(q, k, v, out, bh, sq, skv, d, group, causal, scale, s);
  }
  return launch<256>(q, k, v, out, bh, sq, skv, d, group, causal, scale, s);
}

}  // extern "C"
