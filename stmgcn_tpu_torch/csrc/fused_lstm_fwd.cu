// Fused multi-layer LSTM forward (zero initial state), fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in stmgcn_tpu/ops/pallas_lstm.py
// (launched by `_run_fwd`, public entry `fused_lstm`): the whole T x L
// recurrence for a block of rows, with every hidden and cell state kept on
// chip between steps and layers. Layer 0's input projection x @ wx0 + b0 is
// hoisted outside, as on the TPU; layers >= 1 contract [h_below, h_prev]
// against one packed (2H, 4H) weight.
//
// What bounds it on this card: operations. At the serving shape (M=3
// branches x 64 requests x 256 nodes = 49,152 rows, T=12, L=3, H=64) the
// recurrent products are 163,840 FLOP per row-step, ~96.6 GFLOP in all,
// against ~0.25 ms of compulsory device-memory traffic: a 1.44 ms floor at
// the 67 TFLOP/s fp32 (non-tensor-core) peak. The math is true fp32 (no
// TF32, no fast-math: expf/tanhf), so tensor cores are out of reach here.
//
// What the design does about it:
// - one CTA per (branch, block of rows); blockIdx.y picks the branch's
//   weights, so all M branches run in one launch;
// - one thread per (hidden unit j, group of 8 rows). It owns that unit's four
//   gate columns (j, H+j, 2H+j, 3H+j) for its rows, so the cell update and
//   the cell states of every layer stay in its registers;
// - each weight read (coalesced across j, served from L1/L2: 320 KiB at
//   L=3, H=64 is more than a block's shared memory) feeds 8 rows' FMAs, and
//   each hidden-state read is a warp-wide shared-memory broadcast (a warp is
//   32 units of one row group), so the inner loop is FMA-bound;
// - h is double-buffered by step parity in shared memory, k-major with a
//   padded row stride, so one __syncthreads per (step, layer) suffices;
// - rows past R (the ragged edge) compute on zeros and are never stored.
// Tensor cores (wgmma) and TMA-fed weight tiles are later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;

__device__ __forceinline__ float sigmoid_f32(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// acc[r][q] += sum_k hs[k * stride + r] * w[k * h4 + q * H + j], k < K.
__device__ __forceinline__ void accumulate(float (&acc)[kRowsPerThread][4],
                                           const float* hs,
                                           const float* __restrict__ w,
                                           int K, int stride, int H, int j) {
    const int h4 = 4 * H;
    const float* wj = w + j;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
        const float4 lo = *reinterpret_cast<const float4*>(hs + k * stride);
        const float4 hi = *reinterpret_cast<const float4*>(hs + k * stride + 4);
        const float hv[kRowsPerThread] = {lo.x, lo.y, lo.z, lo.w,
                                          hi.x, hi.y, hi.z, hi.w};
        const float* wk = wj + static_cast<size_t>(k) * h4;
        const float w0 = __ldg(wk);
        const float w1 = __ldg(wk + H);
        const float w2 = __ldg(wk + 2 * H);
        const float w3 = __ldg(wk + 3 * H);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
            acc[r][0] = fmaf(hv[r], w0, acc[r][0]);
            acc[r][1] = fmaf(hv[r], w1, acc[r][1]);
            acc[r][2] = fmaf(hv[r], w2, acc[r][2]);
            acc[r][3] = fmaf(hv[r], w3, acc[r][3]);
        }
    }
}

// Layouts (M = branches, leading everywhere):
//   xp (M, R, T, 4H); wh0 (M, H, 4H); wxh (M, max(L-1,1), 2H, 4H);
//   bias (M, max(L-1,1), 4H); out (M, R, T, H); h_fin/c_fin (M, L, R, H);
//   hseq/cseq (M, T, L, R, H) or null.
template <int L>
__global__ void __launch_bounds__(kThreads, 2)
lstm_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ wh0,
                const float* __restrict__ wxh, const float* __restrict__ bias,
                float* __restrict__ out, float* __restrict__ h_fin,
                float* __restrict__ c_fin, float* __restrict__ hseq,
                float* __restrict__ cseq, int R, int T, int H) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);

    const int groups = kThreads / H;
    const int block_rows = groups * kRowsPerThread;
    const int stride = block_rows + 4;  // padded: 4-way bank conflicts on stores
    const int tile = H * stride;        // one layer's k-major h tile
    const int j = threadIdx.x % H;
    const int g = threadIdx.x / H;
    const int m = blockIdx.y;
    const int row0 = blockIdx.x * block_rows + g * kRowsPerThread;
    const int h4 = 4 * H;
    constexpr int LW = L > 1 ? L - 1 : 1;

    xp += static_cast<size_t>(m) * R * T * h4;
    wh0 += static_cast<size_t>(m) * H * h4;
    wxh += static_cast<size_t>(m) * LW * 2 * H * h4;
    bias += static_cast<size_t>(m) * LW * h4;

    for (int i = threadIdx.x; i < 2 * L * tile; i += kThreads) smem[i] = 0.0f;
    float c[L][kRowsPerThread];
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) c[l][r] = 0.0f;
    __syncthreads();

    for (int t = 0; t < T; ++t) {
        float* cur = smem + (t & 1) * L * tile;
        const float* prv = smem + ((t & 1) ^ 1) * L * tile;
#pragma unroll
        for (int l = 0; l < L; ++l) {
            float acc[kRowsPerThread][4];
            if (l == 0) {
#pragma unroll
                for (int r = 0; r < kRowsPerThread; ++r) {
                    const int row = row0 + r;
                    const float* x =
                        xp + (static_cast<size_t>(row) * T + t) * h4 + j;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        acc[r][q] = row < R ? x[q * H] : 0.0f;
                }
                accumulate(acc, prv + g * kRowsPerThread, wh0, H, stride, H, j);
            } else {
                const float* w = wxh + static_cast<size_t>(l - 1) * 2 * H * h4;
                const float* b = bias + (l - 1) * h4 + j;
#pragma unroll
                for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[r][q] = b[q * H];
                accumulate(acc, cur + (l - 1) * tile + g * kRowsPerThread, w, H,
                           stride, H, j);
                accumulate(acc, prv + l * tile + g * kRowsPerThread,
                           w + static_cast<size_t>(H) * h4, H, stride, H, j);
            }
            float* h_dst = cur + l * tile + j * stride + g * kRowsPerThread;
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) {
                const float ig = sigmoid_f32(acc[r][0]);
                const float fg = sigmoid_f32(acc[r][1]);
                const float gg = tanhf(acc[r][2]);
                const float og = sigmoid_f32(acc[r][3]);
                c[l][r] = fg * c[l][r] + ig * gg;
                const float h = og * tanhf(c[l][r]);
                h_dst[r] = h;
                const int row = row0 + r;
                if (row < R) {
                    if (hseq != nullptr) {
                        const size_t o =
                            ((((static_cast<size_t>(m) * T + t) * L + l) * R + row) * H) + j;
                        hseq[o] = h;
                        cseq[o] = c[l][r];
                    }
                    if (l == L - 1)
                        out[((static_cast<size_t>(m) * R + row) * T + t) * H + j] = h;
                    if (t == T - 1) {
                        const size_t o =
                            ((static_cast<size_t>(m) * L + l) * R + row) * H + j;
                        h_fin[o] = h;
                        c_fin[o] = c[l][r];
                    }
                }
            }
            __syncthreads();
        }
    }
}

template <int L>
cudaError_t launch(const float* xp, const float* wh0, const float* wxh,
                   const float* bias, float* out, float* h_fin, float* c_fin,
                   float* hseq, float* cseq, int M, int R, int T, int H,
                   cudaStream_t stream) {
    const int block_rows = (kThreads / H) * kRowsPerThread;
    const size_t smem = sizeof(float) * 2 * L * H * (block_rows + 4);
    cudaError_t err = cudaFuncSetAttribute(
        lstm_fwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((R + block_rows - 1) / block_rows, M);
    lstm_fwd_kernel<L><<<grid, kThreads, smem, stream>>>(
        xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, R, T, H);
    return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes. Returns a cudaError_t (0 = launched).
// H must divide 256 and be a multiple of 32; 1 <= L <= 4; hseq/cseq may be
// null (forward-only serving).
extern "C" int stmgcn_lstm_fwd(const float* xp, const float* wh0,
                               const float* wxh, const float* bias, float* out,
                               float* h_fin, float* c_fin, float* hseq,
                               float* cseq, int M, int R, int T, int L, int H,
                               void* stream) {
    if (H < 32 || H % 32 != 0 || kThreads % H != 0 || M < 1 || R < 1 || T < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if ((hseq == nullptr) != (cseq == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (L) {
        case 1: return static_cast<int>(launch<1>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, H, s));
        case 2: return static_cast<int>(launch<2>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, H, s));
        case 3: return static_cast<int>(launch<3>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, H, s));
        case 4: return static_cast<int>(launch<4>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, H, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
