// Block-CSR sparse x dense products, fp32, for Hopper (sm_90a): three
// kernels on one body.
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
// (L, R, C) their block-column indices. Padding slots carry index 0 and a
// zero block; block column 0 can be real, so every stored slot is computed.
//
// One body computes out[o, r*t + i, f] = sum over the S sources s of
// o, over the C slots c and over j < t, of
//     data[l, r, c, i, j] * src[l / src_div][idx[l, r, c] * t + j, f],
// with l = o * S + s. The forward is O = M*K, S = 1, src_div = K (the
// branch of support l) and a branch stride of 0 when x is shared; the
// backward is O = M (or 1 when x was shared), S = K (or M*K), src = g.
//
// What bounds it on an H100: bytes for a narrow signal, operations for a
// wide one. At bench.py's largeN metro city (N = 8,192, t = 128, C = 15
// stored blocks per block row, M*K = 9 supports) one launch reads 566 MB of
// blocks: 0.17 ms at 3.35 TB/s. At F = B*T = 10 columns (the contextual
// gate) that is the floor; at F = B*H = 128 (the graph conv) the products
// of the 3,864 blocks that hold a nonzero are 16.2 GFLOP, 0.24 ms at the
// 67 TFLOP/s fp32 peak (the kernel also multiplies the 4,776 all-zero
// padding blocks: 36.2 GFLOP). True fp32 (no TF32).
//
// What the design does about it:
// - one CTA per (output group o, block row r, column tile of FT columns);
//   it loops over its sources and their stored blocks itself, so the sum
//   over s, c and j has no atomics: every output element is summed by one
//   thread in a fixed order, and two runs agree bitwise (the TPU kernel
//   instead revisits its output block across in-order grid steps);
// - the column tile FT (16, 32 or 64) follows the signal's width, so a
//   10-column signal does not pay for 64;
// - per block, 32-column chunks of A and the matching 32 gathered rows of
//   the signal are staged in shared memory; each thread owns a (TM x 4)
//   register tile of the output, reads A four columns at a time (row
//   stride padded so a warp's two to eight rows fall in different banks)
//   and the signal as a warp-wide broadcast;
// - rows of the signal past its end (ragged N) load as zeros, output rows
//   past n_out_rows and columns past F are never stored, so neither the
//   signal nor the output is padded in device memory.
// wgmma is out (fp32 only); TMA-fed double buffering of the blocks is later
// work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 32;  // block columns staged per step
constexpr int kPad = 4;     // row padding of the staged A chunk (floats)

struct Args {
    const float* data;
    const int* idx;
    const float* src;
    float* out;
    int S, R, C, F, n_out_rows, n_src_rows, src_div;
    long long src_stride;
};

template <int T, int FT>
__device__ __forceinline__ void block_csr_body(const Args& a) {
    constexpr int kLanes = FT / 4;              // column groups of 4
    constexpr int kRowGroups = kThreads / kLanes;
    constexpr int TM = T / kRowGroups;          // output rows per thread
    static_assert(TM >= 1 && T % kRowGroups == 0, "tile too small for FT");
    static_assert(T % kChunk == 0, "tile must be a multiple of the chunk");

    __shared__ __align__(16) float As[T][kChunk + kPad];
    __shared__ __align__(16) float Xs[kChunk][FT];

    const int tid = threadIdx.x;
    const int lane = tid % kLanes;
    const int rg = tid / kLanes;
    const int f0 = blockIdx.x * FT;
    const int r = blockIdx.y;
    const int o = blockIdx.z;

    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

    for (int s = 0; s < a.S; ++s) {
        const long long l = static_cast<long long>(o) * a.S + s;
        const float* xs = a.src + (l / a.src_div) * a.src_stride;
        const int* idx_row = a.idx + (l * a.R + r) * a.C;
        const float* blk_row = a.data + (l * a.R + r) * a.C * static_cast<long long>(T * T);
        for (int c = 0; c < a.C; ++c) {
            const float* blk = blk_row + static_cast<long long>(c) * (T * T);
            const long long x_row0 = static_cast<long long>(idx_row[c]) * T;
            for (int j0 = 0; j0 < T; j0 += kChunk) {
                __syncthreads();  // the previous chunk is consumed
                for (int e = tid; e < T * kChunk / 4; e += kThreads) {
                    const int row = e / (kChunk / 4), q = e % (kChunk / 4);
                    *reinterpret_cast<float4*>(&As[row][q * 4]) =
                        __ldg(reinterpret_cast<const float4*>(
                            blk + static_cast<long long>(row) * T + j0 + q * 4));
                }
                for (int e = tid; e < kChunk * FT; e += kThreads) {
                    const int jj = e / FT, ff = e % FT;
                    const long long xr = x_row0 + j0 + jj;
                    const int xc = f0 + ff;
                    Xs[jj][ff] = (xr < a.n_src_rows && xc < a.F)
                                     ? __ldg(xs + xr * a.F + xc)
                                     : 0.0f;
                }
                __syncthreads();
#pragma unroll
                for (int j = 0; j < kChunk; j += 4) {
                    float4 xv[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        xv[q] = *reinterpret_cast<const float4*>(&Xs[j + q][lane * 4]);
#pragma unroll
                    for (int i = 0; i < TM; ++i) {
                        const float4 av =
                            *reinterpret_cast<const float4*>(&As[rg + i * kRowGroups][j]);
                        const float am[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
                        for (int q = 0; q < 4; ++q) {
                            acc[i][0] = fmaf(am[q], xv[q].x, acc[i][0]);
                            acc[i][1] = fmaf(am[q], xv[q].y, acc[i][1]);
                            acc[i][2] = fmaf(am[q], xv[q].z, acc[i][2]);
                            acc[i][3] = fmaf(am[q], xv[q].w, acc[i][3]);
                        }
                    }
                }
            }
        }
    }

    float* out = a.out + static_cast<long long>(o) * a.n_out_rows * a.F;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int row = r * T + rg + i * kRowGroups;
        if (row >= a.n_out_rows) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int col = f0 + lane * 4 + q;
            if (col < a.F) out[static_cast<long long>(row) * a.F + col] = acc[i][q];
        }
    }
}

// Three names for one body, so a profiler trace tells the three apart.
template <int T, int FT>
__global__ void __launch_bounds__(kThreads) spmm_stack_fwd_kernel(Args a) {
    block_csr_body<T, FT>(a);
}

template <int T, int FT>
__global__ void __launch_bounds__(kThreads) spmm_stack_bwd_kernel(Args a) {
    block_csr_body<T, FT>(a);
}

template <int T, int FT>
__global__ void __launch_bounds__(kThreads) spmm_kernel(Args a) {
    block_csr_body<T, FT>(a);
}

enum Role { kStackFwd = 0, kStackBwd = 1, kSpmm = 2 };

template <int T, int FT>
cudaError_t launch_tile(int role, const Args& a, int O, cudaStream_t s) {
    const dim3 grid((a.F + FT - 1) / FT, a.R, O);
    switch (role) {
        case kStackFwd: spmm_stack_fwd_kernel<T, FT><<<grid, kThreads, 0, s>>>(a); break;
        case kStackBwd: spmm_stack_bwd_kernel<T, FT><<<grid, kThreads, 0, s>>>(a); break;
        default: spmm_kernel<T, FT><<<grid, kThreads, 0, s>>>(a); break;
    }
    return cudaGetLastError();
}

template <int T>
cudaError_t launch_width(int role, const Args& a, int O, cudaStream_t s) {
    if (a.F <= 16) return launch_tile<T, 16>(role, a, O, s);
    if (a.F <= 32) return launch_tile<T, 32>(role, a, O, s);
    return launch_tile<T, 64>(role, a, O, s);
}

int launch(int role, const float* data, const int* idx, const float* src, float* out,
           int O, int S, int R, int C, int tile, int F, int n_out_rows, int n_src_rows,
           int src_div, long long src_stride, void* stream) {
    if (O < 1 || S < 1 || R < 1 || C < 1 || F < 1 || n_out_rows < 1 || n_src_rows < 1 ||
        src_div < 1 || O > 65535 || R > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{data, idx, src, out, S, R, C, F, n_out_rows, n_src_rows, src_div, src_stride};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (tile) {
        case 64: return static_cast<int>(launch_width<64>(role, a, O, s));
        case 128: return static_cast<int>(launch_width<128>(role, a, O, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Each entry returns the launch's cudaError_t (0 when it was accepted).
extern "C" int stmgcn_spmm_stack_fwd(const float* data, const int* idx, const float* src,
                                     float* out, int O, int S, int R, int C, int tile, int F,
                                     int n_out_rows, int n_src_rows, int src_div,
                                     long long src_stride, void* stream) {
    return launch(kStackFwd, data, idx, src, out, O, S, R, C, tile, F, n_out_rows, n_src_rows,
                  src_div, src_stride, stream);
}

extern "C" int stmgcn_spmm_stack_bwd(const float* data, const int* idx, const float* src,
                                     float* out, int O, int S, int R, int C, int tile, int F,
                                     int n_out_rows, int n_src_rows, int src_div,
                                     long long src_stride, void* stream) {
    return launch(kStackBwd, data, idx, src, out, O, S, R, C, tile, F, n_out_rows, n_src_rows,
                  src_div, src_stride, stream);
}

extern "C" int stmgcn_spmm(const float* data, const int* idx, const float* src, float* out,
                           int O, int S, int R, int C, int tile, int F, int n_out_rows,
                           int n_src_rows, int src_div, long long src_stride, void* stream) {
    return launch(kSpmm, data, idx, src, out, O, S, R, C, tile, F, n_out_rows, n_src_rows,
                  src_div, src_stride, stream);
}
