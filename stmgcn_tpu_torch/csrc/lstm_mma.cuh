// Building blocks shared by the LSTM forward (fused_lstm_fwd.cu) and
// backward (fused_lstm_bwd.cu) kernels and the block-CSR SpMMs
// (spmm_stack.cu): the LSTM tile shapes per hidden width, the two product
// routes (fp32 storage: 3xTF32 on mma.sync m16n8k8; bf16 storage: one
// mma.sync m16n8k16 bf16 pass), both with fp32 accumulation, behind the
// policies F32 and BF16, and cp.async copies. The xla form (fp32 storage,
// bf16 products) takes BF16's products over fp32 tiles: fragments rounded
// to bf16 as they load, or split in two bf16 halves where an operand must
// keep fp32 precision (split2).
//
// 3xTF32: an fp32 operand x is split as x = hi + lo, hi rounded to TF32 (10
// mantissa bits, round to nearest) and lo truncated to TF32 by the tensor
// core, and a product a*b is taken as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with
// fp32 accumulation: the small terms first, the lo*lo term (2^-22 of the
// product) dropped. That keeps each product within a few fp32 roundings,
// where one TF32 pass (2^-11) misses the kernels' fp32 tolerances
// (tests/test_torch_lstm_tf32.py rehearses both on the CPU). The split is
// integer and fp32 arithmetic, not cvt: conversions issue at a fraction of
// the ALU rate, and there are 24 splits per 48 mma in every k-step.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), lane = 4 * g + q:
//   A (16 x 8, row-major): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8 x 8, k x n):      b0 (q, g), b1 (q + 4, g)
//   C (16 x 8):            c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
//
// bf16 (mma.m16n8k16 .bf16, two values per 32-bit register, the lower k in
// the low half):
//   A (16 x 16, row-major): r0 (g, 2q..2q+1), r1 (g + 8, 2q..2q+1),
//                           r2 (g, 2q+8..2q+9), r3 (g + 8, 2q+8..2q+9)
//   B (16 x 8, k x n):      r0 (2q..2q+1, g), r1 (2q+8..2q+9, g)
//   C as m16n8k8's. A product of two bf16 values is exact in fp32, so one
//   pass is the whole product; fp32 values are rounded to bf16 (round to
//   nearest even, __float2bfloat16_rn, as XLA's convert) where the JAX
//   kernel casts them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace lstm_mma {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // bytes of shared memory a block may use on sm_90

// The per-(step, layer) product is rows x K against K x 4H. The Warps warps
// of a CTA split it as WM (rows) x WN (hidden units); each warp owns MT
// m-tiles of 16 rows and, for each of the four gates, UT n-tiles of 8 units,
// so one thread holds all four gates of the same (row, unit) pairs and the
// cell update runs in the accumulator registers. MT * UT = 32 / Warps: 64
// fp32 accumulators per thread with 8 warps, 32 with 16; the rows per CTA
// (BR) are the same either way.
struct F32;
struct BF16;

template <int H, int Warps = kWarps, typename P = F32>
struct Tile {
    static_assert(H == 32 || H == 64 || H == 128 || H == 256, "H in {32, 64, 128, 256}");
    static_assert(Warps == 8 || Warps == 16, "8 or 16 warps");
    static constexpr int Threads = 32 * Warps;
    static constexpr int WN = H <= 64 ? 4 : Warps == 8 ? 8 : H / 16;
    static constexpr int WM = Warps / WN;
    static constexpr int UW = H / WN;       // units per warp
    static constexpr int UT = UW / 8;
    static constexpr int MT = 32 / (Warps * UT);
    static constexpr int RW = 16 * MT;      // rows per warp
    static constexpr int BR = WM * RW;      // rows per CTA: 128, 64, 32, 16
    // The rows per CTA are set by the fp32 accumulators and cell states in
    // registers, the same in both storage types. In shared memory (strides
    // in elements of the storage type): weight rows per ring stage (bf16
    // takes twice the rows, so a stage holds as many bytes and the k-loop
    // whole m16n8k16 steps), the h tile's row stride (rows on 16-byte
    // boundaries for cp.async; A-fragment loads conflict-free) and the
    // weight stage's.
    static constexpr bool kBf16 = sizeof(typename P::T) == 2;
    static constexpr int KC = (H <= 64 ? 16 : 8) * (kBf16 ? 2 : 1);
    static constexpr int HS = H + (kBf16 ? 8 : 4);
    static constexpr int WS = 4 * H + 8;
    static_assert(MT >= 1 && WM * WN == Warps, "tiling covers the warps");
    static_assert(KC % P::KS == 0, "whole mma k-steps per ring stage");
};

__device__ __forceinline__ float sigmoid_f32(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// x = hi + lo: hi is x rounded to TF32 (round to nearest, ties away from
// zero, as cvt.rna.tf32.f32, but in two integer operations: a carry out of
// the mantissa correctly bumps the exponent); lo = x - hi is exact in fp32
// and goes to the tensor core as it is, which reads a .tf32 operand's top
// 19 bits (so lo is truncated to TF32: 2^-21 of x at most)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA {
    uint32_t hi[4], lo[4];
};
struct FragB {
    uint32_t hi[2], lo[2];
};

// A from a row-major tile (p at its (row 0, k 0), row stride s)
__device__ __forceinline__ void load_a(FragA& f, const float* p, int s, int g, int q) {
    split(p[g * s + q], f.hi[0], f.lo[0]);
    split(p[(g + 8) * s + q], f.hi[1], f.lo[1]);
    split(p[g * s + q + 4], f.hi[2], f.lo[2]);
    split(p[(g + 8) * s + q + 4], f.hi[3], f.lo[3]);
}

// A = P^T from a k-major tile P (p at its (k 0, row 0), k stride s)
__device__ __forceinline__ void load_a_t(FragA& f, const float* p, int s, int g, int q) {
    split(p[q * s + g], f.hi[0], f.lo[0]);
    split(p[q * s + g + 8], f.hi[1], f.lo[1]);
    split(p[(q + 4) * s + g], f.hi[2], f.lo[2]);
    split(p[(q + 4) * s + g + 8], f.hi[3], f.lo[3]);
}

// B from a k-major tile (p at its (k 0, n 0), k stride s)
__device__ __forceinline__ void load_b(FragB& f, const float* p, int s, int g, int q) {
    split(p[q * s + g], f.hi[0], f.lo[0]);
    split(p[(q + 4) * s + g], f.hi[1], f.lo[1]);
}

// B = P^T from an n-major tile P (p at its (n 0, k 0), n stride s)
__device__ __forceinline__ void load_b_t(FragB& f, const float* p, int s, int g, int q) {
    split(p[g * s + q], f.hi[0], f.lo[0]);
    split(p[g * s + q + 4], f.hi[1], f.lo[1]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
    mma_tf32(d, a.lo, b.hi);
    mma_tf32(d, a.hi, b.lo);
    mma_tf32(d, a.hi, b.hi);
}

using bf16 = __nv_bfloat16;

struct FragA16 {
    uint32_t r[4];
};
struct FragB16 {
    uint32_t r[2];
};

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
// two fp32 values rounded to bf16 (nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// A from a row-major bf16 tile (p at its (row 0, k 0), row stride s, even)
__device__ __forceinline__ void load_a(FragA16& f, const bf16* p, int s, int g, int q) {
    f.r[0] = ld32(p + g * s + 2 * q);
    f.r[1] = ld32(p + (g + 8) * s + 2 * q);
    f.r[2] = ld32(p + g * s + 2 * q + 8);
    f.r[3] = ld32(p + (g + 8) * s + 2 * q + 8);
}

// A from a row-major fp32 tile (p 8-byte aligned, s even), each value
// rounded to bf16
__device__ __forceinline__ void load_a(FragA16& f, const float* p, int s, int g, int q) {
    const float2 v0 = *reinterpret_cast<const float2*>(p + g * s + 2 * q);
    const float2 v1 = *reinterpret_cast<const float2*>(p + (g + 8) * s + 2 * q);
    const float2 v2 = *reinterpret_cast<const float2*>(p + g * s + 2 * q + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(p + (g + 8) * s + 2 * q + 8);
    f.r[0] = pack(v0.x, v0.y);
    f.r[1] = pack(v1.x, v1.y);
    f.r[2] = pack(v2.x, v2.y);
    f.r[3] = pack(v3.x, v3.y);
}

// A = P^T from a k-major bf16 tile P (p at its (k 0, row 0), k stride s)
__device__ __forceinline__ void load_a_t(FragA16& f, const bf16* p, int s, int g, int q) {
    const bf16* k0 = p + 2 * q * s;
    const bf16* k8 = p + (2 * q + 8) * s;
    f.r[0] = pack(k0[g], k0[s + g]);
    f.r[1] = pack(k0[g + 8], k0[s + g + 8]);
    f.r[2] = pack(k8[g], k8[s + g]);
    f.r[3] = pack(k8[g + 8], k8[s + g + 8]);
}

// A = P^T from a k-major fp32 tile P, each value rounded to bf16
__device__ __forceinline__ void load_a_t(FragA16& f, const float* p, int s, int g, int q) {
    const float* k0 = p + 2 * q * s;
    const float* k8 = p + (2 * q + 8) * s;
    f.r[0] = pack(k0[g], k0[s + g]);
    f.r[1] = pack(k0[g + 8], k0[s + g + 8]);
    f.r[2] = pack(k8[g], k8[s + g]);
    f.r[3] = pack(k8[g + 8], k8[s + g + 8]);
}

// Two bf16 halves of fp32 values: hi = bf16(x), lo = bf16(x - hi), so hi + lo
// holds x to about 2^-17 of it. A product of an fp32 operand with an exact
// bf16 one is taken as two bf16 passes, lo first (the xla form's products
// of the unrounded fp32 dgates; its result is rounded to bf16 after the
// sum, 2^-9, so the dropped part does not show)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
    const bf16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
    hi = pack(ha, hb);
    lo = pack(a - __bfloat162float(ha), b - __bfloat162float(hb));
}

// A from a row-major fp32 tile (p 8-byte aligned, s even), split in halves
__device__ __forceinline__ void load_a_split(FragA16& hi, FragA16& lo, const float* p, int s,
                                             int g, int q) {
    const float2 v0 = *reinterpret_cast<const float2*>(p + g * s + 2 * q);
    const float2 v1 = *reinterpret_cast<const float2*>(p + (g + 8) * s + 2 * q);
    const float2 v2 = *reinterpret_cast<const float2*>(p + g * s + 2 * q + 8);
    const float2 v3 = *reinterpret_cast<const float2*>(p + (g + 8) * s + 2 * q + 8);
    split2(v0.x, v0.y, hi.r[0], lo.r[0]);
    split2(v1.x, v1.y, hi.r[1], lo.r[1]);
    split2(v2.x, v2.y, hi.r[2], lo.r[2]);
    split2(v3.x, v3.y, hi.r[3], lo.r[3]);
}

// B from a k-major fp32 tile, split in halves
__device__ __forceinline__ void load_b_split(FragB16& hi, FragB16& lo, const float* p, int s,
                                             int g, int q) {
    split2(p[2 * q * s + g], p[(2 * q + 1) * s + g], hi.r[0], lo.r[0]);
    split2(p[(2 * q + 8) * s + g], p[(2 * q + 9) * s + g], hi.r[1], lo.r[1]);
}

// B from a k-major tile (p at its (k 0, n 0), k stride s), bf16 or fp32
// (rounded to bf16)
template <typename E>
__device__ __forceinline__ void load_b(FragB16& f, const E* p, int s, int g, int q) {
    f.r[0] = pack(p[2 * q * s + g], p[(2 * q + 1) * s + g]);
    f.r[1] = pack(p[(2 * q + 8) * s + g], p[(2 * q + 9) * s + g]);
}

// B = P^T from an n-major bf16 tile P (p at its (n 0, k 0), n stride s, even)
__device__ __forceinline__ void load_b_t(FragB16& f, const bf16* p, int s, int g, int q) {
    f.r[0] = ld32(p + g * s + 2 * q);
    f.r[1] = ld32(p + g * s + 2 * q + 8);
}

// d += a * b, bf16 operands, fp32 accumulation: one pass
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The storage types' product routes: T the storage type, KS the k-depth of
// one mma step, FA/FB its fragments, mma(d, a, b) the step with fp32
// accumulation
struct F32 {
    using T = float;
    static constexpr int KS = 8;
    using FA = FragA;
    using FB = FragB;
    static __device__ __forceinline__ void mma(float (&d)[4], const FA& a, const FB& b) {
        mma3(d, a, b);
    }
};
struct BF16 {
    using T = bf16;
    static constexpr int KS = 16;
    using FA = FragA16;
    using FB = FragB16;
    static __device__ __forceinline__ void mma(float (&d)[4], const FA& a, const FB& b) {
        mma_bf16(d, a.r, b.r);
    }
};

// Two or four consecutive storage values to and from fp32 (stores round to
// nearest even)
__device__ __forceinline__ float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float2 v) {
    *reinterpret_cast<float2*>(p) = v;
}
__device__ __forceinline__ void store2(bf16* p, float2 v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __float22bfloat162_rn(v);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack(v.x, v.y), pack(v.z, v.w));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
// x rounded to bf16 (nearest even) and read back as fp32: an fp32 value
// through the JAX scan's astype(bf16)
__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// 16-byte global -> shared copy; zero-fills the 16 bytes when !valid (src
// must still be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0));
}

// 4-byte global -> shared copy, for rows that do not start on a 16-byte
// boundary (.ca: .cg takes 16 bytes only); zero-fills when !valid (src must
// still be a mapped address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// The largest ring depth in [2, cap] (cap <= 4) whose stages fit beside
// `fixed` bytes; each plan static_asserts that its total fits, 2 stages too
constexpr int ring_stages(int fixed_bytes, int stage_bytes, int cap = 4) {
    return cap >= 4 && fixed_bytes + 4 * stage_bytes <= kSmemLimit ? 4
         : cap >= 3 && fixed_bytes + 3 * stage_bytes <= kSmemLimit ? 3
                                                                  : 2;
}

// cudaFuncGetAttributes of one kernel instance into info[4]: registers per
// thread, local (spilled) bytes per thread, the most threads a block of it
// may have, static shared bytes. Returns a cudaError_t.
template <typename Kernel>
int func_attrs(Kernel kernel, int* info) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    info[0] = a.numRegs;
    info[1] = static_cast<int>(a.localSizeBytes);
    info[2] = a.maxThreadsPerBlock;
    info[3] = static_cast<int>(a.sharedSizeBytes);
    return 0;
}

}  // namespace lstm_mma
