// Fused multi-layer LSTM backward (zero initial state), fp32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` in stmgcn_tpu/ops/pallas_lstm.py
// (launched by `_fused_bwd`): the reverse sweep over t and layers that
// recomputes each step's gate pre-activations from the saved h/c residuals
// (written by fused_lstm_fwd.cu), turns the h/c cotangents into gate
// cotangents (`dgates`), carries dh/dc back through time and down the layers,
// and produces the weight gradients dWh0, dWxh and db.
//
// What bounds it on this card: operations. At the training shape (M=3
// branches x 64 samples x 256 nodes = 49,152 rows, T=12, L=3, H=64) it does
// the forward's 163,840 FLOP per row-step three times over (gate recompute,
// dgates @ W^T, hin^T @ dgates): ~290 GFLOP, a 4.33 ms floor at the 67
// TFLOP/s fp32 (non-tensor-core) peak, against ~2.3 GB of compulsory traffic
// (0.68 ms at 3.35 TB/s). True fp32 throughout: no TF32, no fast-math.
//
// What the design does about it. The TPU kernel adds every row block's
// weight gradient into one output block (`+=` across grid steps), which is
// race-free only because a TPU grid runs in order. A CUDA grid does not, and
// one CTA's full partial weight gradient (82,432 floats at L=3, H=64) fits
// neither its shared memory nor its registers. So the work is split in two
// passes, with no atomics (bitwise-deterministic results):
//
// 1. `lstm_bwd_sweep`: the recurrence. One CTA per (branch, block of rows),
//    blockIdx.y the branch, as in the forward. One thread per (hidden unit j,
//    8 rows) owns that unit's four gate columns, so the recompute reuses the
//    forward's FMA loop (h tiles k-major in shared memory, weight reads
//    coalesced across j) and dh/dc of every layer stay in registers. The
//    cotangent product dgates @ W^T reads *transposed* packed weights
//    (W^T (4H, K), passed by the wrapper), so its weight reads are coalesced
//    across j too, while dgates go through shared memory as warp-wide
//    broadcasts. Layer 0's dgates are the output dxp; layers >= 1 write theirs
//    to a scratch tensor (M, T, L-1, R, 4H), and db is summed per CTA in
//    registers and written as one partial per CTA.
// 2. `lstm_bwd_wgrad`: dW = sum_{t,r} hin^T dgates for every (branch, layer)
//    as a tiled split-K product: each CTA owns a 64x64 tile of dW and one
//    chunk of (t, r) rows, reads hin straight from hseq (zeros at t = 0) and
//    dgates from dxp / the scratch, and writes its partial tile.
// 3. `reduce_partials`: sums the split-K partials (and the db partials) in a
//    fixed order into the outputs.
// Rows past R compute on zeros and are never stored. Tensor cores (wgmma
// with a split-precision scheme), TMA and a fused weight-gradient epilogue are
// later work.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 8;
// weight-gradient tiles: 64 (k) x 64 (gate column), 16 rows per stage,
// 4096 (t, r) rows per split-K chunk
constexpr int kTile = 64;
constexpr int kStage = 16;
constexpr int kChunk = 4096;

__device__ __forceinline__ float sigmoid_f32(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// acc[r][q] += sum_k hs[k * stride + r] * w[k * h4 + q * H + j], k < K
// (the forward kernel's gate product, used here to recompute the gates).
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

// out[r] += sum_c dg[c * stride + r] * wt[c * K + j], c < 4H: one column j
// of dgates @ W^T for this thread's rows, from transposed weights wt (4H, K).
__device__ __forceinline__ void accumulate_t(float (&out)[kRowsPerThread],
                                             const float* dg,
                                             const float* __restrict__ wt,
                                             int h4, int K, int stride, int j) {
    const float* wj = wt + j;
#pragma unroll 4
    for (int c = 0; c < h4; ++c) {
        const float4 lo = *reinterpret_cast<const float4*>(dg + c * stride);
        const float4 hi = *reinterpret_cast<const float4*>(dg + c * stride + 4);
        const float w = __ldg(wj + static_cast<size_t>(c) * K);
        out[0] = fmaf(lo.x, w, out[0]);
        out[1] = fmaf(lo.y, w, out[1]);
        out[2] = fmaf(lo.z, w, out[2]);
        out[3] = fmaf(lo.w, w, out[3]);
        out[4] = fmaf(hi.x, w, out[4]);
        out[5] = fmaf(hi.y, w, out[5]);
        out[6] = fmaf(hi.z, w, out[6]);
        out[7] = fmaf(hi.w, w, out[7]);
    }
}

// Two-output variant for layers >= 1: columns j (h_below) and H + j (h_prev).
__device__ __forceinline__ void accumulate_t2(float (&lo_out)[kRowsPerThread],
                                              float (&hi_out)[kRowsPerThread],
                                              const float* dg,
                                              const float* __restrict__ wt,
                                              int h4, int K, int stride, int H,
                                              int j) {
    const float* wj = wt + j;
#pragma unroll 4
    for (int c = 0; c < h4; ++c) {
        const float4 lo = *reinterpret_cast<const float4*>(dg + c * stride);
        const float4 hi = *reinterpret_cast<const float4*>(dg + c * stride + 4);
        const float dv[kRowsPerThread] = {lo.x, lo.y, lo.z, lo.w,
                                          hi.x, hi.y, hi.z, hi.w};
        const float* wc = wj + static_cast<size_t>(c) * K;
        const float wa = __ldg(wc);
        const float wb = __ldg(wc + H);
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
            lo_out[r] = fmaf(dv[r], wa, lo_out[r]);
            hi_out[r] = fmaf(dv[r], wb, hi_out[r]);
        }
    }
}

// Stores this thread's 8 rows of one unit into a k-major smem tile
// (two 16-byte stores; stride and row offsets are multiples of 4).
__device__ __forceinline__ void store_rows(float* tile, const float (&v)[kRowsPerThread]) {
    reinterpret_cast<float4*>(tile)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(tile)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Layouts (M = branches, leading everywhere):
//   xp (M, R, T, 4H); wh0 (M, H, 4H); wxh (M, max(L-1,1), 2H, 4H);
//   bias (M, max(L-1,1), 4H); wh0t (M, 4H, H); wxht (M, max(L-1,1), 4H, 2H);
//   hseq/cseq (M, T, L, R, H); gout (M, R, T, H); ghfin/gcfin (M, L, R, H);
//   dxp (M, R, T, 4H); dg (M, T, L-1, R, 4H); part_db (gridDim.x, M, L-1, 4H).
template <int L>
__global__ void __launch_bounds__(kThreads, 2)
lstm_bwd_sweep(const float* __restrict__ xp, const float* __restrict__ wh0,
               const float* __restrict__ wxh, const float* __restrict__ bias,
               const float* __restrict__ wh0t, const float* __restrict__ wxht,
               const float* __restrict__ hseq, const float* __restrict__ cseq,
               const float* __restrict__ gout, const float* __restrict__ ghfin,
               const float* __restrict__ gcfin, float* __restrict__ dxp,
               float* __restrict__ dg, float* __restrict__ part_db, int M,
               int R, int T, int H) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);

    const int groups = kThreads / H;
    const int block_rows = groups * kRowsPerThread;
    const int stride = block_rows + 4;
    const int j = threadIdx.x % H;
    const int g = threadIdx.x / H;
    const int m = blockIdx.y;
    const int row0 = blockIdx.x * block_rows + g * kRowsPerThread;
    const int h4 = 4 * H;
    constexpr int LW = L > 1 ? L - 1 : 1;

    // shared memory: h_below and h_prev tiles (H x stride each, k-major),
    // then the dgates tile (4H x stride, gate-column-major)
    float* hb_tile = smem;
    float* hp_tile = smem + H * stride;
    float* dg_tile = smem + 2 * H * stride;
    const int my = g * kRowsPerThread;

    xp += static_cast<size_t>(m) * R * T * h4;
    wh0 += static_cast<size_t>(m) * H * h4;
    wxh += static_cast<size_t>(m) * LW * 2 * H * h4;
    bias += static_cast<size_t>(m) * LW * h4;
    wh0t += static_cast<size_t>(m) * h4 * H;
    wxht += static_cast<size_t>(m) * LW * h4 * 2 * H;
    hseq += static_cast<size_t>(m) * T * L * R * H;
    cseq += static_cast<size_t>(m) * T * L * R * H;
    gout += static_cast<size_t>(m) * R * T * H;
    dxp += static_cast<size_t>(m) * R * T * h4;

    // h/c sequence element (t, l, row, j)
    auto seq_at = [&](int t, int l, int row) -> size_t {
        return ((static_cast<size_t>(t) * L + l) * R + row) * H + j;
    };

    float dh[L][kRowsPerThread], dc[L][kRowsPerThread];
    float dbacc[LW][4];
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
            const int row = row0 + r;
            const size_t o = ((static_cast<size_t>(m) * L + l) * R + row) * H + j;
            dh[l][r] = row < R ? ghfin[o] : 0.0f;
            dc[l][r] = row < R ? gcfin[o] : 0.0f;
        }
#pragma unroll
    for (int l = 0; l < LW; ++l)
#pragma unroll
        for (int q = 0; q < 4; ++q) dbacc[l][q] = 0.0f;

    for (int t = T - 1; t >= 0; --t) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
            const int row = row0 + r;
            if (row < R) dh[L - 1][r] += gout[(static_cast<size_t>(row) * T + t) * H + j];
        }
#pragma unroll
        for (int l = L - 1; l >= 0; --l) {
            // (a) this step's inputs into shared memory: h_prev = h[t-1, l]
            // (zero at t = 0) and, for l >= 1, h_below = h[t, l-1]
            {
                float hp[kRowsPerThread], hb[kRowsPerThread];
#pragma unroll
                for (int r = 0; r < kRowsPerThread; ++r) {
                    const int row = row0 + r;
                    hp[r] = (t > 0 && row < R) ? hseq[seq_at(t - 1, l, row)] : 0.0f;
                    hb[r] = (l > 0 && row < R) ? hseq[seq_at(t, l > 0 ? l - 1 : 0, row)] : 0.0f;
                }
                store_rows(hp_tile + j * stride + my, hp);
                if (l > 0) store_rows(hb_tile + j * stride + my, hb);
            }
            __syncthreads();

            // (b) recompute the pre-activations, as the forward did
            float acc[kRowsPerThread][4];
            if (l == 0) {
#pragma unroll
                for (int r = 0; r < kRowsPerThread; ++r) {
                    const int row = row0 + r;
                    const float* x = xp + (static_cast<size_t>(row) * T + t) * h4 + j;
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[r][q] = row < R ? x[q * H] : 0.0f;
                }
                accumulate(acc, hp_tile + my, wh0, H, stride, H, j);
            } else {
                const float* w = wxh + static_cast<size_t>(l - 1) * 2 * H * h4;
                const float* b = bias + (l - 1) * h4 + j;
#pragma unroll
                for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
                    for (int q = 0; q < 4; ++q) acc[r][q] = b[q * H];
                accumulate(acc, hb_tile + my, w, H, stride, H, j);
                accumulate(acc, hp_tile + my, w + static_cast<size_t>(H) * h4, H,
                           stride, H, j);
            }

            // (c) gate cotangents; acc becomes dgates in place
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) {
                const int row = row0 + r;
                const bool live = row < R;
                const float c_t = live ? cseq[seq_at(t, l, row)] : 0.0f;
                const float c_prev = (live && t > 0) ? cseq[seq_at(t - 1, l, row)] : 0.0f;
                const float ig = sigmoid_f32(acc[r][0]);
                const float fg = sigmoid_f32(acc[r][1]);
                const float gg = tanhf(acc[r][2]);
                const float og = sigmoid_f32(acc[r][3]);
                const float tc = tanhf(c_t);
                const float d_o = dh[l][r] * tc;
                const float dct = dc[l][r] + dh[l][r] * og * (1.0f - tc * tc);
                const float zero_pad = live ? 1.0f : 0.0f;
                acc[r][0] = zero_pad * (dct * gg * ig * (1.0f - ig));
                acc[r][1] = zero_pad * (dct * c_prev * fg * (1.0f - fg));
                acc[r][2] = zero_pad * (dct * ig * (1.0f - gg * gg));
                acc[r][3] = zero_pad * (d_o * og * (1.0f - og));
                dc[l][r] = dct * fg;
            }

            // (d) dgates out: dxp for layer 0, the scratch for layers >= 1
            // (read back by lstm_bwd_wgrad), the db sums, and the smem tile
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) {
                const int row = row0 + r;
                if (row >= R) continue;
                float* dst = l == 0
                    ? dxp + (static_cast<size_t>(row) * T + t) * h4 + j
                    : dg + ((((static_cast<size_t>(m) * T + t) * LW + (l - 1)) * R + row) * h4) + j;
#pragma unroll
                for (int q = 0; q < 4; ++q) dst[q * H] = acc[r][q];
            }
            if (l > 0) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    float s = 0.0f;
#pragma unroll
                    for (int r = 0; r < kRowsPerThread; ++r) s += acc[r][q];
                    dbacc[l > 0 ? l - 1 : 0][q] += s;
                }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float v[kRowsPerThread] = {acc[0][q], acc[1][q], acc[2][q], acc[3][q],
                                                 acc[4][q], acc[5][q], acc[6][q], acc[7][q]};
                store_rows(dg_tile + (q * H + j) * stride + my, v);
            }
            __syncthreads();

            // (e) dh through the weights: dgates @ W^T from the smem tile
            if (l == 0) {
                float out[kRowsPerThread] = {};
                accumulate_t(out, dg_tile + my, wh0t, h4, H, stride, j);
#pragma unroll
                for (int r = 0; r < kRowsPerThread; ++r) dh[0][r] = out[r];
            } else {
                float below[kRowsPerThread] = {}, rec[kRowsPerThread] = {};
                accumulate_t2(below, rec, dg_tile + my,
                              wxht + static_cast<size_t>(l - 1) * h4 * 2 * H, h4,
                              2 * H, stride, H, j);
#pragma unroll
                for (int r = 0; r < kRowsPerThread; ++r) {
                    dh[l > 0 ? l - 1 : 0][r] += below[r];
                    dh[l][r] = rec[r];
                }
            }
            // the next step's first __syncthreads orders these smem reads
            // before the tiles are overwritten
        }
    }

    if (L > 1) {
        // db: this CTA's row groups summed in a fixed order via shared memory
        __syncthreads();
        float* red = dg_tile;  // groups x (L-1) x 4H floats, fits the tile
#pragma unroll
        for (int l = 0; l < LW; ++l)
#pragma unroll
            for (int q = 0; q < 4; ++q) red[(g * LW + l) * h4 + q * H + j] = dbacc[l][q];
        __syncthreads();
        for (int i = threadIdx.x; i < LW * h4; i += kThreads) {
            float s = 0.0f;
            for (int gg = 0; gg < groups; ++gg) s += red[gg * LW * h4 + i];
            part_db[(static_cast<size_t>(blockIdx.x) * M + m) * LW * h4 + i] = s;
        }
    }
}

// Split-K weight gradients. Grid: (chunks, tiles, M * L). The CTA for
// (chunk, tile, m * L + l) sums hin[n, k] * dgates[n, c] over rows
// n = t * R + r of its chunk, for its 64x64 (k, c) tile of layer l's dW, and
// writes the partial to part[chunk][...], laid out as dwh0 (M, H, 4H)
// followed by dwxh (M, L-1, 2H, 4H).
__global__ void __launch_bounds__(kThreads)
lstm_bwd_wgrad(const float* __restrict__ hseq, const float* __restrict__ dxp,
               const float* __restrict__ dg, float* __restrict__ part, int M,
               int R, int T, int L, int H) {
    __shared__ __align__(16) float a_s[kStage][kTile];
    __shared__ __align__(16) float g_s[kStage][kTile];

    const int m = blockIdx.z / L;
    const int l = blockIdx.z % L;
    const int h4 = 4 * H;
    const int K = l == 0 ? H : 2 * H;
    const int c_tiles = h4 / kTile;
    const int k_tiles = (K + kTile - 1) / kTile;
    if (static_cast<int>(blockIdx.y) >= k_tiles * c_tiles) return;
    const int kt = blockIdx.y / c_tiles;
    const int ct = blockIdx.y % c_tiles;
    const int LW = L > 1 ? L - 1 : 1;
    const long long n_total = static_cast<long long>(T) * R;
    const long long n_begin = static_cast<long long>(blockIdx.x) * kChunk;
    const long long n_end = n_begin + kChunk < n_total ? n_begin + kChunk : n_total;

    const int tid = threadIdx.x;
    const int ld_row = tid / 16;       // staged row this thread loads
    const int ld_col = (tid % 16) * 4;  // its 4 columns within the tile
    const int tx = tid % 16;            // output columns tx*4 .. +4
    const int ty = tid / 16;            // output k rows ty*4 .. +4
    const int k_ld = kt * kTile + ld_col;
    const int c_ld = ct * kTile + ld_col;

    float acc[4][4] = {};
    for (long long n0 = n_begin; n0 < n_end; n0 += kStage) {
        const long long n = n0 + ld_row;
        float4 a4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 g4 = a4;
        if (n < n_end) {
            const int t = static_cast<int>(n / R);
            const int r = static_cast<int>(n % R);
            auto seq = [&](int tt, int ll) {
                return hseq + ((((static_cast<size_t>(m) * T + tt) * L + ll) * R + r) * H);
            };
            if (l == 0) {
                if (t > 0 && k_ld < H) a4 = *reinterpret_cast<const float4*>(seq(t - 1, 0) + k_ld);
                g4 = *reinterpret_cast<const float4*>(
                    dxp + ((static_cast<size_t>(m) * R + r) * T + t) * h4 + c_ld);
            } else {
                if (k_ld < H)
                    a4 = *reinterpret_cast<const float4*>(seq(t, l - 1) + k_ld);
                else if (t > 0)
                    a4 = *reinterpret_cast<const float4*>(seq(t - 1, l) + (k_ld - H));
                g4 = *reinterpret_cast<const float4*>(
                    dg + (((static_cast<size_t>(m) * T + t) * LW + (l - 1)) * R + r) * h4 + c_ld);
            }
        }
        *reinterpret_cast<float4*>(&a_s[ld_row][ld_col]) = a4;
        *reinterpret_cast<float4*>(&g_s[ld_row][ld_col]) = g4;
        __syncthreads();
#pragma unroll
        for (int s = 0; s < kStage; ++s) {
            const float4 a = *reinterpret_cast<const float4*>(&a_s[s][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&g_s[s][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(av[i], bv[q], acc[i][q]);
        }
        __syncthreads();
    }

    const size_t x_total = static_cast<size_t>(M) * H * h4 +
                           (L > 1 ? static_cast<size_t>(M) * (L - 1) * 2 * H * h4 : 0);
    float* out = part + blockIdx.x * x_total +
                 (l == 0 ? static_cast<size_t>(m) * H * h4
                         : static_cast<size_t>(M) * H * h4 +
                               (static_cast<size_t>(m) * (L - 1) + (l - 1)) * 2 * H * h4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int k = kt * kTile + ty * 4 + i;
        if (k < K)
            *reinterpret_cast<float4*>(out + static_cast<size_t>(k) * h4 + ct * kTile + tx * 4) =
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
}

// out[i] = sum_{p < P} part[p * X + i] in order p = 0, 1, ...; entries below
// `split` go to out0, the rest to out1[i - split].
__global__ void reduce_partials(const float* __restrict__ part, int P, size_t X,
                                size_t split, float* __restrict__ out0,
                                float* __restrict__ out1) {
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < X;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        float s = 0.0f;
        for (int p = 0; p < P; ++p) s += part[static_cast<size_t>(p) * X + i];
        if (i < split)
            out0[i] = s;
        else
            out1[i - split] = s;
    }
}

struct Plan {
    int block_rows, row_blocks, chunks;
    size_t dg_floats, db_floats, dw_floats, dw_split, smem;
};

Plan plan(int M, int R, int T, int L, int H) {
    Plan p;
    p.block_rows = (kThreads / H) * kRowsPerThread;
    p.row_blocks = (R + p.block_rows - 1) / p.block_rows;
    const long long n_total = static_cast<long long>(T) * R;
    p.chunks = static_cast<int>((n_total + kChunk - 1) / kChunk);
    const size_t h4 = 4 * static_cast<size_t>(H);
    p.dg_floats = L > 1 ? static_cast<size_t>(M) * T * (L - 1) * R * h4 : 0;
    p.db_floats = L > 1 ? static_cast<size_t>(p.row_blocks) * M * (L - 1) * h4 : 0;
    p.dw_split = static_cast<size_t>(M) * H * h4;
    p.dw_floats = p.dw_split + (L > 1 ? static_cast<size_t>(M) * (L - 1) * 2 * H * h4 : 0);
    p.smem = sizeof(float) * (2 * H + 4 * H) * static_cast<size_t>(p.block_rows + 4);
    return p;
}

bool bad_shape(int M, int R, int T, int L, int H) {
    return H < 32 || H % 32 != 0 || kThreads % H != 0 || M < 1 || R < 1 ||
           T < 1 || L < 1 || L > 4;
}

template <int L>
cudaError_t launch_sweep(const Plan& p, const float* xp, const float* wh0,
                         const float* wxh, const float* bias, const float* wh0t,
                         const float* wxht, const float* hseq, const float* cseq,
                         const float* gout, const float* ghfin, const float* gcfin,
                         float* dxp, float* dg, float* part_db, int M, int R, int T,
                         int H, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_sweep<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(p.row_blocks, M);
    lstm_bwd_sweep<L><<<grid, kThreads, p.smem, stream>>>(
        xp, wh0, wxh, bias, wh0t, wxht, hseq, cseq, gout, ghfin, gcfin, dxp, dg,
        part_db, M, R, T, H);
    return cudaGetLastError();
}

}  // namespace

// Floats of scratch the backward needs (layer >= 1 dgates, per-CTA db
// partials, split-K weight-gradient partials); the wrapper allocates them.
extern "C" size_t stmgcn_lstm_bwd_workspace(int M, int R, int T, int L, int H) {
    if (bad_shape(M, R, T, L, H)) return 0;
    const Plan p = plan(M, R, T, L, H);
    return p.dg_floats + p.db_floats + p.chunks * p.dw_floats;
}

// C entry point bound with ctypes. Returns a cudaError_t (0 = launched).
// Same shape rules as the forward: H divides 256 and is a multiple of 32,
// 1 <= L <= 4. wh0t/wxht are wh0/wxh with their last two axes swapped. For
// L == 1, dwxh and db are placeholders that are not written.
extern "C" int stmgcn_lstm_bwd(const float* xp, const float* wh0, const float* wxh,
                               const float* bias, const float* wh0t,
                               const float* wxht, const float* hseq,
                               const float* cseq, const float* gout,
                               const float* ghfin, const float* gcfin, float* dxp,
                               float* dwh0, float* dwxh, float* db,
                               float* workspace, int M, int R, int T, int L, int H,
                               void* stream) {
    if (bad_shape(M, R, T, L, H)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Plan p = plan(M, R, T, L, H);
    float* dg = workspace;
    float* part_db = dg + p.dg_floats;
    float* part_dw = part_db + p.db_floats;

    cudaError_t err;
    switch (L) {
        case 1: err = launch_sweep<1>(p, xp, wh0, wxh, bias, wh0t, wxht, hseq, cseq, gout, ghfin, gcfin, dxp, dg, part_db, M, R, T, H, s); break;
        case 2: err = launch_sweep<2>(p, xp, wh0, wxh, bias, wh0t, wxht, hseq, cseq, gout, ghfin, gcfin, dxp, dg, part_db, M, R, T, H, s); break;
        case 3: err = launch_sweep<3>(p, xp, wh0, wxh, bias, wh0t, wxht, hseq, cseq, gout, ghfin, gcfin, dxp, dg, part_db, M, R, T, H, s); break;
        default: err = launch_sweep<4>(p, xp, wh0, wxh, bias, wh0t, wxht, hseq, cseq, gout, ghfin, gcfin, dxp, dg, part_db, M, R, T, H, s); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);

    const int max_tiles = ((2 * H + kTile - 1) / kTile) * (4 * H / kTile);
    const dim3 wgrid(p.chunks, max_tiles, M * L);
    lstm_bwd_wgrad<<<wgrid, kThreads, 0, s>>>(hseq, dxp, dg, part_dw, M, R, T, L, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const size_t rblocks = (p.dw_floats + kThreads - 1) / kThreads;
    const int rgrid = rblocks < 2048 ? static_cast<int>(rblocks) : 2048;
    reduce_partials<<<rgrid, kThreads, 0, s>>>(part_dw, p.chunks, p.dw_floats,
                                               p.dw_split, dwh0, dwxh);
    err = cudaGetLastError();
    if (err != cudaSuccess || L == 1) return static_cast<int>(err);

    const size_t db_x = static_cast<size_t>(M) * (L - 1) * 4 * H;
    const int dblocks = static_cast<int>((db_x + kThreads - 1) / kThreads);
    reduce_partials<<<dblocks, kThreads, 0, s>>>(part_db, p.row_blocks, db_x, db_x,
                                                 db, db);
    return static_cast<int>(cudaGetLastError());
}
