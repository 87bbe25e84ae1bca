// Block-CSR sparse x dense products for Hopper (sm_90a): three kernels on
// one body, the products on the tensor cores in 3xTF32 (fp32 blocks and
// signal) or one bf16 pass (bf16 blocks and signal), fp32 out either way.
//
// Replaces the TPU kernels of stmgcn_tpu/ops/spmm.py:
// - spmm_stack_fwd_kernel: `_stack_fwd_kernel` (launched by `_stack_fwd_call`,
//   public entry `spmm_stack`): out[k] = A_k @ x for all K supports, here for
//   all M graph branches too, in one launch;
// - spmm_stack_bwd_kernel: `_stack_bwd_kernel` (launched by
//   `_stack_bwd_call`): dx = sum_k A_k^T @ g_k over the pre-transposed block
//   structure (data_t, idx_t), summed over the branches too when x was
//   shared by them;
// - spmm_kernel: `_spmm_kernel` (launched by `_spmm_call`, public entry
//   `spmm`): one support's A @ x; its backward is the same kernel on the
//   transposed structure.
//
// A support is stored as uniform block-CSR: `data` (L, R, C, t, t) holds the
// C stored (t, t) blocks of each of the R block rows of L supports, `idx`
// (L, R, C) their block-column indices and `nblk` (L, R) how many leading
// slots of each row hold a nonzero. The host-side structures pack a row's
// nonzero blocks first; the slots from nblk on are padding (zero blocks at
// index 0).
//
// One body computes, for each block row (l, r),
//     part[l % S][l / S][r*t + i, f] = sum over the real slots c < nblk[l, r]
//         and j < t of data[l, r, c, i, j] * src[l / src_div][idx[l, r, c]*t + j, f]
// and out[o] = part[0][o] + ... + part[S-1][o] in that order. The forward
// is S = 1 (out[l] = A_l @ x), src_div = K (the branch of support l) and a
// branch stride of 0 when x is shared; the backward is S = K (or M*K when
// x was shared by the branches) over the transposed blocks, src = g.
// Skipping a padding slot drops the product of a zero block, which changes
// no result for a finite signal. A non-finite signal value is outside what
// the kernels promise: the TPU kernel multiplies the padding too, so there
// 0 * inf gives NaN in rows that here never read that value.
//
// What bounds it on an H100, at bench.py's largeN metro city (N = 8,192,
// t = 128, C = 15 stored blocks per block row, M*K = 9 supports; 3,864 of
// the 8,640 stored blocks hold a nonzero): one launch reads 253 MB of real
// blocks, 0.076 ms at 3.35 TB/s. At F = B*T = 10 columns (the contextual
// gate) that is the floor. At F = B*H = 128 (the graph conv) the products
// are 16.2 GFLOP: 0.098 ms as three TF32 passes at the 495 TFLOP/s peak
// (0.24 ms as fp32 FMAs at 67 TFLOP/s).
//
// What the design does about it:
// - one CTA per (block row (l, r), column tile of FT columns); FT (16, 32,
//   64 or 128) follows the signal's width, so a signal of up to 128 columns
//   reads each block once, and a wider one (serving's top rung: 256) takes
//   128-column tiles;
// - the CTA reads the real slots of its row only, each block in chunks of
//   kKC columns: the A chunk (t x kKC) and the matching kKC gathered signal
//   rows (kKC x FT) come through a ring of cp.async stages, so the next
//   chunk's loads (across blocks) run under this chunk's products. Signal
//   rows that start on 16-byte boundaries (F % 4 == 0) are copied 16 bytes
//   at a time, others (the gate conv's F = 10, a ragged F = 37) 4 bytes at
//   a time; rows past the signal's end are zero-filled;
// - rows hold 1 to C real blocks (the metro city: 1 to 15), one CTA runs
//   per SM, and a long row started last would run on alone: the grid takes
//   the rows in `order`, heaviest first (the structures' `row_order`);
// - 8 warps tile the t x FT output (a warp owns up to 64 x 32) with
//   mma.sync m16n8k8 in 3xTF32 (lstm_mma.cuh: fp32 accuracy). Each block's
//   t-deep product is summed from zero and then added to an fp32 running
//   sum, because the tensor cores' accumulation truncates
//   (tests/test_torch_spmm_tf32.py rehearses both on the CPU). Every width
//   takes this path: the gate conv's F = 10 runs a 16-column tile, an
//   eighth of the graph conv's products, and bytes bound it either way;
// - no atomics: every output element is summed by one thread in a fixed
//   order. The backward's S sources of an output block are S CTAs (the
//   gradient of a per-branch signal has only M = 3 output groups, too few
//   CTAs to fill the card), each writing its partial to scratch, and
//   `reduce_parts` sums the partials in order, so two runs agree bitwise
//   (the TPU kernel instead revisits its output block across in-order grid
//   steps);
// - output rows past n_out_rows and columns past F are never stored, so
//   neither the signal nor the output is padded in device memory.
//
// bf16 (the JAX kernels at a bf16 compute dtype: blocks cast to the
// signal's dtype, `jnp.dot(..., preferred_element_type=f32)`, f32 out): the
// blocks and the signal arrive in bf16 and each product is one mma.sync
// m16n8k16 bf16 pass (exact products, fp32 accumulation), each block's
// t-deep sum again a run from zero added to the fp32 running sum; the
// output and the backward's partials stay fp32. Stages hold bf16 at half
// the bytes, so the ring is 4 deep at every width; signal rows go 16 bytes
// at a time where F % 8 == 0 and rows start on 16-byte boundaries, else
// one value at a time (no 2-byte cp.async exists).

#include <cuda_runtime.h>

#include <cstddef>

#include "lstm_mma.cuh"

namespace {

using namespace lstm_mma;

constexpr int kKC = 64;    // block columns (gathered signal rows) per ring stage

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The tiling of one (t, FT) instance in storage type P::T: WM x WN warps,
// each owning MT m-tiles of 16 rows and NT n-tiles of 8 columns; the padded
// strides make every fragment load conflict-free (fp32, in words: A kKC + 4
// = 4 mod 32 per row, X FT + 8 = 8 or 24 mod 32 per row; bf16, in elements:
// A kKC + 8, 36 words a row, X FT + 8, 8 q words apart for k-rows 2q).
template <typename Pr, int T, int FT>
struct Plan {
    using E = typename Pr::T;
    static constexpr int kPadA = sizeof(E) == 4 ? 4 : 8;  // row padding of a staged A chunk
    static constexpr int kPadX = 8;                       // of a staged signal chunk
    static_assert(T == 64 || T == 128, "tile 64 or 128");
    static_assert(FT == 16 || FT == 32 || FT == 64 || FT == 128, "column tile 16..128");
    static constexpr int WM = cmin(T / 16, kWarps / (FT >= 32 ? FT / 32 : 1));
    static constexpr int WN = kWarps / WM;
    static constexpr int MT = T / (16 * WM);
    static constexpr int NT = FT / (8 * WN);
    static_assert(WM * WN == kWarps && MT >= 1 && NT >= 1, "warps tile the output");
    static_assert(16 * MT * WM == T && 8 * NT * WN == FT, "warps cover the output");
    static constexpr int NCH = T / kKC;  // ring stages per block
    static constexpr int V = 16 / sizeof(E);  // elements per 16-byte copy
    static constexpr int SA = kKC + kPadA;
    static constexpr int SX = FT + kPadX;
    static constexpr int A_ELEMS = T * SA;
    static constexpr int STAGE = A_ELEMS + kKC * SX;  // elements
    static constexpr int STAGES = ring_stages(0, sizeof(E) * STAGE);
    static constexpr int SMEM = STAGES * STAGE * sizeof(E);
    static_assert(SMEM <= kSmemLimit && 2 * STAGE * sizeof(E) <= kSmemLimit, "ring fits");
    static_assert(T % kKC == 0 && kKC % Pr::KS == 0 && STAGE % V == 0 && SA % V == 0 &&
                      SX % V == 0, "16-byte stage rows, whole mma k-steps");
};

struct Args {
    const void* data;  // the storage type's blocks
    const int* idx;
    const int* nblk;
    const int* order;  // the flat rows l * R + r in the order the grid takes them
    const void* src;   // the storage type's signal
    float* out;  // (S, L / S, n_out_rows, F): the output itself when S == 1
    int L, R, C, F, n_out_rows, n_src_rows, src_div, S;
    int vec;  // signal rows start on 16-byte boundaries
    long long src_stride;
};

template <typename Pr, int T, int FT>
__device__ __forceinline__ void block_csr_body(const Args& a) {
    using P = Plan<Pr, T, FT>;
    using E = typename Pr::T;
    extern __shared__ __align__(16) float4 smem4[];
    E* smem = reinterpret_cast<E*>(smem4);
    const E* data = static_cast<const E*>(a.data);
    const E* src = static_cast<const E*>(a.src);

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, q = lane % 4;
    const int row_w = (warp / P::WN) * P::MT * 16;  // the warp's first row and column
    const int col_w = (warp % P::WN) * P::NT * 8;
    const int item = a.order[blockIdx.x];
    const int l = item / a.R, r = item % a.R;
    const int f0 = blockIdx.y * FT;

    const long long row_slots = (static_cast<long long>(l) * a.R + r) * a.C;
    const int nb = a.nblk[item];
    const int total = (nb < 0 ? 0 : nb < a.C ? nb : a.C) * P::NCH;  // this CTA's stages
    const E* xs = src + static_cast<long long>(l / a.src_div) * a.src_stride;
    constexpr int V = P::V;

    auto load_stage = [&](int stage, int k) {  // chunk k % NCH of real slot k / NCH
        E* As = smem + stage * P::STAGE;
        E* Xs = As + P::A_ELEMS;
        const long long slot = row_slots + k / P::NCH;
        const int j0 = (k % P::NCH) * kKC;
        const E* blk = data + slot * (T * T) + j0;
        for (int e = tid; e < T * kKC / V; e += kThreads) {
            const int row = e / (kKC / V), cv = e % (kKC / V);
            cp_async16(As + row * P::SA + cv * V, blk + row * T + cv * V, true);
        }
        const long long x_row0 = static_cast<long long>(a.idx[slot]) * T + j0;
        if (a.vec) {
            for (int e = tid; e < kKC * FT / V; e += kThreads) {
                const int jj = e / (FT / V), cv = e % (FT / V);
                const long long xr = x_row0 + jj;
                const int xc = f0 + cv * V;
                const bool ok = xr < a.n_src_rows && xc < a.F;
                cp_async16(Xs + jj * P::SX + cv * V, ok ? xs + xr * a.F + xc : src, ok);
            }
        } else {
            for (int e = tid; e < kKC * FT; e += kThreads) {
                const int jj = e / FT, ff = e % FT;
                const long long xr = x_row0 + jj;
                const int xc = f0 + ff;
                const bool ok = xr < a.n_src_rows && xc < a.F;
                if constexpr (sizeof(E) == 4) {
                    cp_async4(Xs + jj * P::SX + ff, ok ? xs + xr * a.F + xc : src, ok);
                } else {  // a plain copy: the __syncthreads before the stage is read orders it
                    Xs[jj * P::SX + ff] = ok ? xs[xr * a.F + xc] : __float2bfloat16_rn(0.0f);
                }
            }
        }
    };

    float sum[P::MT][P::NT][4], acc[P::MT][P::NT][4];
#pragma unroll
    for (int m = 0; m < P::MT; ++m)
#pragma unroll
        for (int n = 0; n < P::NT; ++n)
#pragma unroll
            for (int v = 0; v < 4; ++v) sum[m][n][v] = acc[m][n][v] = 0.0f;

#pragma unroll
    for (int k = 0; k < P::STAGES - 1; ++k) {
        if (k < total) load_stage(k, k);
        cp_async_commit();
    }
    for (int k = 0; k < total; ++k) {
        cp_async_wait<P::STAGES - 2>();
        __syncthreads();  // stage k landed; stage k - 1 is consumed by every warp
        const int next = k + P::STAGES - 1;
        if (next < total) load_stage(next % P::STAGES, next);
        cp_async_commit();

        const int ch = k % P::NCH;
        if (ch == 0) {
#pragma unroll
            for (int m = 0; m < P::MT; ++m)
#pragma unroll
                for (int n = 0; n < P::NT; ++n)
#pragma unroll
                    for (int v = 0; v < 4; ++v) acc[m][n][v] = 0.0f;
        }
        const E* As = smem + (k % P::STAGES) * P::STAGE + row_w * P::SA;
        const E* Xs = smem + (k % P::STAGES) * P::STAGE + P::A_ELEMS + col_w;
#pragma unroll
        for (int kk = 0; kk < kKC; kk += Pr::KS) {
            typename Pr::FB b[P::NT];
#pragma unroll
            for (int n = 0; n < P::NT; ++n) load_b(b[n], Xs + kk * P::SX + n * 8, P::SX, g, q);
#pragma unroll
            for (int m = 0; m < P::MT; ++m) {
                typename Pr::FA fa;
                load_a(fa, As + m * 16 * P::SA + kk, P::SA, g, q);
                if constexpr (sizeof(E) == 4) {
#pragma unroll
                    for (int n = 0; n < P::NT; ++n) mma_tf32(acc[m][n], fa.lo, b[n].hi);
#pragma unroll
                    for (int n = 0; n < P::NT; ++n) mma_tf32(acc[m][n], fa.hi, b[n].lo);
#pragma unroll
                    for (int n = 0; n < P::NT; ++n) mma_tf32(acc[m][n], fa.hi, b[n].hi);
                } else {
#pragma unroll
                    for (int n = 0; n < P::NT; ++n) Pr::mma(acc[m][n], fa, b[n]);
                }
            }
        }
        if (ch == P::NCH - 1) {  // the block's product joins the running sum
#pragma unroll
            for (int m = 0; m < P::MT; ++m)
#pragma unroll
                for (int n = 0; n < P::NT; ++n)
#pragma unroll
                    for (int v = 0; v < 4; ++v) sum[m][n][v] += acc[m][n][v];
        }
    }
    cp_async_wait<0>();  // only empty groups can be left; nothing in flight at exit

    // source l % S of output group l / S
    const long long group = static_cast<long long>(l % a.S) * (a.L / a.S) + l / a.S;
    float* out = a.out + group * a.n_out_rows * a.F;
    const bool pairs = a.F % 2 == 0;  // then (row, col) with col even is 8-byte aligned
#pragma unroll
    for (int m = 0; m < P::MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = r * T + row_w + m * 16 + g + 8 * h;
            if (row >= a.n_out_rows) continue;
            float* out_row = out + static_cast<long long>(row) * a.F;
#pragma unroll
            for (int n = 0; n < P::NT; ++n) {
                const int col = f0 + col_w + n * 8 + 2 * q;
                const float v0 = sum[m][n][2 * h], v1 = sum[m][n][2 * h + 1];
                if (pairs) {
                    if (col < a.F) *reinterpret_cast<float2*>(out_row + col) = make_float2(v0, v1);
                } else {
                    if (col < a.F) out_row[col] = v0;
                    if (col + 1 < a.F) out_row[col + 1] = v1;
                }
            }
        }
    }
}

// Three names for one body, so a profiler trace tells the three apart.
template <typename Pr, int T, int FT>
__global__ void __launch_bounds__(kThreads, 1) spmm_stack_fwd_kernel(Args a) {
    block_csr_body<Pr, T, FT>(a);
}

template <typename Pr, int T, int FT>
__global__ void __launch_bounds__(kThreads, 1) spmm_stack_bwd_kernel(Args a) {
    block_csr_body<Pr, T, FT>(a);
}

template <typename Pr, int T, int FT>
__global__ void __launch_bounds__(kThreads, 1) spmm_kernel(Args a) {
    block_csr_body<Pr, T, FT>(a);
}

// out[i] = part[0][i] + part[1][i] + ... in order s = 0, 1, ...
__global__ void reduce_parts(const float* __restrict__ part, int S, long long X,
                             float* __restrict__ out) {
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < X;
         i += static_cast<long long>(gridDim.x) * blockDim.x) {
        float s = part[i];
        for (int p = 1; p < S; ++p) s += part[p * X + i];
        out[i] = s;
    }
}

enum Role { kStackFwd = 0, kStackBwd = 1, kSpmm = 2 };

template <typename Pr, int T, int FT>
cudaError_t launch_tile(int role, const Args& a, cudaStream_t s) {
    using P = Plan<Pr, T, FT>;
    void (*kern)(Args) = role == kStackFwd   ? &spmm_stack_fwd_kernel<Pr, T, FT>
                         : role == kStackBwd ? &spmm_stack_bwd_kernel<Pr, T, FT>
                                             : &spmm_kernel<Pr, T, FT>;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid(a.L * a.R, (a.F + FT - 1) / FT);
    kern<<<grid, kThreads, P::SMEM, s>>>(a);
    return cudaGetLastError();
}

// The column tile of a signal F wide: the narrowest of 16, 32, 64 that
// holds it, else 128
inline int column_tile(int F) { return F <= 16 ? 16 : F <= 32 ? 32 : F <= 64 ? 64 : 128; }

template <typename Pr, int T>
cudaError_t launch_width(int role, const Args& a, cudaStream_t s) {
    switch (column_tile(a.F)) {
        case 16: return launch_tile<Pr, T, 16>(role, a, s);
        case 32: return launch_tile<Pr, T, 32>(role, a, s);
        case 64: return launch_tile<Pr, T, 64>(role, a, s);
        default: return launch_tile<Pr, T, 128>(role, a, s);
    }
}

template <typename Pr, int T, int FT>
void plan_info(int* info) {
    using P = Plan<Pr, T, FT>;
    info[0] = FT;
    info[1] = P::STAGES;
    info[2] = P::SMEM;
    info[3] = P::MT * 16;
    info[4] = P::NT * 8;
}

template <typename Pr, int T, int FT>
int attrs_tile(int role, int* info) {
    void (*kern)(Args) = role == kStackFwd   ? &spmm_stack_fwd_kernel<Pr, T, FT>
                         : role == kStackBwd ? &spmm_stack_bwd_kernel<Pr, T, FT>
                                             : &spmm_kernel<Pr, T, FT>;
    return func_attrs(kern, info);
}

template <typename Pr, int T>
int attrs_width(int role, int F, int* info) {
    switch (column_tile(F)) {
        case 16: return attrs_tile<Pr, T, 16>(role, info);
        case 32: return attrs_tile<Pr, T, 32>(role, info);
        case 64: return attrs_tile<Pr, T, 64>(role, info);
        default: return attrs_tile<Pr, T, 128>(role, info);
    }
}

template <typename Pr, int T>
void plan_width(int F, int* info) {
    switch (column_tile(F)) {
        case 16: return plan_info<Pr, T, 16>(info);
        case 32: return plan_info<Pr, T, 32>(info);
        case 64: return plan_info<Pr, T, 64>(info);
        default: return plan_info<Pr, T, 128>(info);
    }
}

template <typename Pr>
cudaError_t launch_p(int role, int tile, const Args& a, cudaStream_t s) {
    switch (tile) {
        case 64: return launch_width<Pr, 64>(role, a, s);
        case 128: return launch_width<Pr, 128>(role, a, s);
        default: return cudaErrorInvalidValue;
    }
}

int launch(int role, const void* data, const int* idx, const int* nblk, const int* order,
           const void* src, float* out, float* part, int L, int S, int R, int C, int tile,
           int F, int n_out_rows, int n_src_rows, int src_div, long long src_stride, int vec,
           int bf16, void* stream) {
    if (L < 1 || S < 1 || L % S || R < 1 || C < 1 || F < 1 || n_out_rows < 1 ||
        n_src_rows < 1 || src_div < 1 || (S > 1 && part == nullptr) ||
        static_cast<long long>(L) * R > 0x7fffffffLL || (F + 15) / 16 > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{data, idx, nblk, order, src, S > 1 ? part : out, L, R, C, F, n_out_rows,
                 n_src_rows, src_div, S, vec, src_stride};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = bf16 ? launch_p<BF16>(role, tile, a, s) : launch_p<F32>(role, tile, a, s);
    if (err != cudaSuccess || S == 1) return static_cast<int>(err);
    const long long X = static_cast<long long>(L / S) * n_out_rows * F;
    const long long blocks = (X + 255) / 256;
    reduce_parts<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(part, S, X,
                                                                                 out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan of the instance a launch at (tile, F) and storage type takes,
// into info[5]: column tile, ring stages, dynamic shared memory (bytes) per
// CTA, and the rows and columns one warp owns. Returns 0, or
// cudaErrorInvalidValue for a tile the kernels do not take.
extern "C" int stmgcn_spmm_plan(int tile, int F, int bf16, int* info) {
    switch (tile) {
        case 64: bf16 ? plan_width<BF16, 64>(F, info) : plan_width<F32, 64>(F, info); return 0;
        case 128: bf16 ? plan_width<BF16, 128>(F, info) : plan_width<F32, 128>(F, info); return 0;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The compiled instance of kernel `role` (0 stack forward, 1 stack
// backward, 2 single support) a launch at (tile, F) and storage type takes,
// into info[4] (func_attrs: registers, spilled bytes per thread, max
// threads per block, static shared bytes); cudaErrorInvalidValue for a tile
// or role the kernels do not take.
extern "C" int stmgcn_spmm_attrs(int role, int tile, int F, int bf16, int* info) {
    if (role < kStackFwd || role > kSpmm) return static_cast<int>(cudaErrorInvalidValue);
    switch (tile) {
        case 64: return bf16 ? attrs_width<BF16, 64>(role, F, info)
                             : attrs_width<F32, 64>(role, F, info);
        case 128: return bf16 ? attrs_width<BF16, 128>(role, F, info)
                              : attrs_width<F32, 128>(role, F, info);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Each entry returns the launch's cudaError_t (0 when it was accepted).
// One CTA per (l, r) block row of the L supports (per column tile); row l
// writes source l % S of output group l / S. With S > 1, `part` is scratch
// of L * n_out_rows * F floats and the S sources are summed into `out` in
// order. `order` (L * R int32, a permutation) is the order the grid takes
// the rows in. `data` and `src` are float32 (bf16 == 0) or both bfloat16
// (bf16 == 1); `out` and `part` are float32 either way.
extern "C" int stmgcn_spmm_stack_fwd(const void* data, const int* idx, const int* nblk,
                                     const int* order, const void* src, float* out,
                                     float* part, int L, int S, int R, int C, int tile, int F,
                                     int n_out_rows, int n_src_rows, int src_div,
                                     long long src_stride, int vec, int bf16, void* stream) {
    return launch(kStackFwd, data, idx, nblk, order, src, out, part, L, S, R, C, tile, F,
                  n_out_rows, n_src_rows, src_div, src_stride, vec, bf16, stream);
}

extern "C" int stmgcn_spmm_stack_bwd(const void* data, const int* idx, const int* nblk,
                                     const int* order, const void* src, float* out,
                                     float* part, int L, int S, int R, int C, int tile, int F,
                                     int n_out_rows, int n_src_rows, int src_div,
                                     long long src_stride, int vec, int bf16, void* stream) {
    return launch(kStackBwd, data, idx, nblk, order, src, out, part, L, S, R, C, tile, F,
                  n_out_rows, n_src_rows, src_div, src_stride, vec, bf16, stream);
}

extern "C" int stmgcn_spmm(const void* data, const int* idx, const int* nblk,
                           const int* order, const void* src, float* out, float* part, int L,
                           int S, int R, int C, int tile, int F, int n_out_rows,
                           int n_src_rows, int src_div, long long src_stride, int vec,
                           int bf16, void* stream) {
    return launch(kSpmm, data, idx, nblk, order, src, out, part, L, S, R, C, tile, F,
                  n_out_rows, n_src_rows, src_div, src_stride, vec, bf16, stream);
}
