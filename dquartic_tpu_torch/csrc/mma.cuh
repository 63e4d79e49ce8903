// Tensor-core helpers of the hand-written kernels (K1, K4, K5): ldmatrix
// and movmatrix fragments, mma.sync on bf16 operands with float32 sums,
// and the (hi, lo) bf16 split whose three products keep about 16 mantissa
// bits of a float32 product; cp.async and the SFU's exp2.
#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ float fast_exp2(float v) {  // MUFU.EX2; denormal results flush to 0
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {  // lo in the low half
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// (hi, lo) of a float32 pair: hi its bf16 rounding, lo the bf16 rounding of
// what hi misses (a in the low halves).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// d (16 x 8, float32) += a (16 x 8, bf16, row) b (8 x 8, bf16, col): the
// first half of m16n8k16's k, its fragments a0, a1 and b0, in half the time
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0, uint32_t a1,
                                            uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// d = a b + c in three bf16 products of the (hi, lo) halves, hi hi + hi lo +
// lo hi: about 16 of float32's 24 mantissa bits (K1's and K4's q and k
// projections, whose results are rounded to bf16 after the exponential; K5's
// weight gradients). An operand exact in bf16 (kExactA, kExactB: its lo
// halves are zeros) skips the product of its lo half. The k of the products:
// at kNarrow k 8-15 are zeros, and each product is an m16n8k8 over k 0-7
// (b*: the b0 fragments); otherwise an m16n8k16 (b*0, b*1).
template <bool kNarrow, bool kExactA = false, bool kExactB = false>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                          uint32_t bl0, uint32_t bl1) {
  if constexpr (kNarrow) {
    mma_bf16_k8(d, ah[0], ah[1], bh0);
    if constexpr (!kExactB) mma_bf16_k8(d, ah[0], ah[1], bl0);
    if constexpr (!kExactA) mma_bf16_k8(d, al[0], al[1], bh0);
  } else {
    mma_bf16(d, ah[0], ah[1], ah[2], ah[3], bh0, bh1);
    if constexpr (!kExactB) mma_bf16(d, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
    if constexpr (!kExactA) mma_bf16(d, al[0], al[1], al[2], al[3], bh0, bh1);
  }
}

// The transpose of an 8 x 8 b16 matrix held as an ldmatrix fragment (lane l
// holds row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1): an mma
// accumulator tile, packed to bf16 pairs, becomes an operand fragment whose
// k runs along the accumulator's rows.
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t r;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(r) : "r"(a));
  return r;
}

}  // namespace
