// Fused multi-layer LSTM forward (zero initial state), fp32 storage, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` in stmgcn_tpu/ops/pallas_lstm.py
// (launched by `_run_fwd`, public entry `fused_lstm`): the whole T x L
// recurrence for a block of rows, with every hidden and cell state kept on
// chip between steps and layers. Layer 0's input projection x @ wx0 + b0 is
// hoisted outside, as on the TPU; layers >= 1 contract [h_below, h_prev]
// against one packed (2H, 4H) weight.
//
// What bounds it on this card: the tensor cores' issue rate, then the
// weights' trips from L2 and the cell math between the products. At the
// serving shape (M=3 branches x 64 requests x 256 nodes = 49,152 rows,
// T=12, L=3, H=64) the recurrent products are 96.6 GFLOP: 1.44 ms at the
// 67 TFLOP/s fp32 FMA peak, 0.585 ms as three TF32 passes at 495 TFLOP/s
// (mma.sync itself reaches about two thirds of that peak: chip_smoke.py's
// probe, csrc/mma_tf32_rate.cu), against ~0.25 ms of compulsory
// device-memory traffic. The weights (320 KiB per step at L=3) do not fit
// in a block's shared memory, so every CTA fetches all of them once per
// step; their L2 traffic is (rows / BR) x T x 320 KiB.
//
// What the design does about it:
// - the products run on the tensor cores (mma.sync m16n8k8 .tf32) in
//   3xTF32 (lstm_mma.cuh), fp32 accumulation: near-fp32 products at a
//   third of the TF32 rate, where plain TF32 misses the fp32 tolerances;
// - one CTA per (branch, block of 16-128 rows, by H: 64 at H=64, twice the
//   first version's), blockIdx.y the branch, so all M branches run in one
//   launch; each weight byte fetched feeds BR rows;
// - the weights stream through a ring of 2-4 shared-memory stages of KC
//   rows each, loaded with cp.async S-1 stages ahead of the math; the
//   sequence of stages is the same for every step, so loads run ahead
//   across layer and step boundaries;
// - warp (wm, wn) owns 16*MT rows and, for each gate, 8*UT hidden units:
//   a thread's accumulators hold all four gates of the same (row, unit)
//   pairs, so the cell update runs in registers, each layer's cell state
//   stays in registers for the whole sweep, and h goes to a shared tile
//   (double-buffered by step parity) that the next products read;
// - padded strides make every fragment load conflict-free; rows past R
//   (the ragged edge) compute on zeros and are never stored.
// The cell math is fp32 with expf/tanhf (no fast-math).

#include <cuda_runtime.h>

#include <cstddef>

#include "lstm_mma.cuh"

namespace {

using namespace lstm_mma;

// The forward's tiling: 8 warps (16, as the backward sweep takes, measured
// no faster here: its state is lighter and fits 255 registers unspilled)
template <int H>
using FwdTile = Tile<H, 8>;
constexpr int NT = FwdTile<64>::Threads;

template <int H, int L>
struct FwdPlan {
    using C = FwdTile<H>;
    static constexpr int hbuf = 2 * L * C::BR * C::HS;  // h tiles, two step parities
    static constexpr int stage = C::KC * C::WS;
    static constexpr int S = ring_stages(hbuf, stage);
    static constexpr int smem_bytes = 4 * (hbuf + S * stage);
    static_assert(smem_bytes <= kSmemLimit, "the h tiles and ring fit in shared memory");
    static constexpr int Q0 = H / C::KC;      // stages of layer 0's weight
    static constexpr int Q1 = 2 * H / C::KC;  // stages of a layer >= 1 weight
    static constexpr int Q = Q0 + (L - 1) * Q1;  // stages per step
};

// Layouts (M = branches, leading everywhere):
//   xp (M, R, T, 4H); wh0 (M, H, 4H); wxh (M, max(L-1,1), 2H, 4H);
//   bias (M, max(L-1,1), 4H); out (M, R, T, H); h_fin/c_fin (M, L, R, H);
//   hseq/cseq (M, T, L, R, H) or null.
template <int H, int L>
__global__ void __launch_bounds__(NT, 1)
lstm_fwd_kernel(const float* __restrict__ xp, const float* __restrict__ wh0,
                const float* __restrict__ wxh, const float* __restrict__ bias,
                float* __restrict__ out, float* __restrict__ h_fin,
                float* __restrict__ c_fin, float* __restrict__ hseq,
                float* __restrict__ cseq, int R, int T) {
    using C = FwdTile<H>;
    using P = FwdPlan<H, L>;
    constexpr int S = P::S, KC = C::KC, HS = C::HS, WS = C::WS, BR = C::BR;
    constexpr int MT = C::MT, UT = C::UT, H4 = 4 * H;
    constexpr int LW = L > 1 ? L - 1 : 1;
    constexpr int TILE = BR * HS;  // one layer's h tile

    extern __shared__ float4 smem4[];
    float* hbuf = reinterpret_cast<float*>(smem4);
    float* ring = hbuf + P::hbuf;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp / C::WN, wn = warp % C::WN;
    const int g = lane >> 2, q = lane & 3;
    const int m = blockIdx.y;
    const int row_base = blockIdx.x * BR;
    const int wrow = wm * C::RW;   // this warp's first row in the tile
    const int wunit = wn * C::UW;  // its first hidden unit

    xp += static_cast<size_t>(m) * R * T * H4;
    wh0 += static_cast<size_t>(m) * H * H4;
    wxh += static_cast<size_t>(m) * LW * 2 * H * H4;
    bias += static_cast<size_t>(m) * LW * H4;

    const int total = T * P::Q;
    // stage n of the weight stream: KC rows of layer l's weight, l and the
    // row offset from n's place in the step
    auto issue = [&](int n) {
        if (n < total) {
            const int p = n % P::Q;
            const float* w;
            int k0;
            if (p < P::Q0) {
                w = wh0;
                k0 = p * KC;
            } else {
                const int r = p - P::Q0;
                w = wxh + static_cast<size_t>(r / P::Q1) * 2 * H * H4;
                k0 = (r % P::Q1) * KC;
            }
            float* dst = ring + (n % S) * P::stage;
            const float* src = w + static_cast<size_t>(k0) * H4;
#pragma unroll
            for (int j = 0; j < KC * H / NT; ++j) {
                const int i = tid + j * NT;
                const int r = i / H, c = (i % H) * 4;
                cp_async16(dst + r * WS + c, src + r * H4 + c, true);
            }
        }
        cp_async_commit();
    };

#pragma unroll
    for (int s = 0; s < S - 1; ++s) issue(s);
    for (int i = tid; i < P::hbuf; i += NT) hbuf[i] = 0.0f;

    float c[L][MT][UT][4];
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int ut = 0; ut < UT; ++ut)
#pragma unroll
                for (int e = 0; e < 4; ++e) c[l][mt][ut][e] = 0.0f;

    int n = 0;  // next stage to consume
    for (int t = 0; t < T; ++t) {
        float* cur = hbuf + (t & 1) * L * TILE;
        const float* prv = hbuf + ((t & 1) ^ 1) * L * TILE;
#pragma unroll
        for (int l = 0; l < L; ++l) {
            const int K = l == 0 ? H : 2 * H;
            float acc[MT][4][UT][4];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int row = row_base + wrow + mt * 16 + g + 8 * hf;
#pragma unroll
                    for (int gt = 0; gt < 4; ++gt)
#pragma unroll
                        for (int ut = 0; ut < UT; ++ut) {
                            const int col = gt * H + wunit + ut * 8 + 2 * q;
                            float2 v = make_float2(0.0f, 0.0f);
                            if (l == 0) {
                                if (row < R)
                                    v = *reinterpret_cast<const float2*>(
                                        xp + (static_cast<size_t>(row) * T + t) * H4 + col);
                            } else {
                                v = *reinterpret_cast<const float2*>(bias + (l - 1) * H4 + col);
                            }
                            acc[mt][gt][ut][2 * hf] = v.x;
                            acc[mt][gt][ut][2 * hf + 1] = v.y;
                        }
                }

#pragma unroll 1
            for (int k0 = 0; k0 < K; k0 += KC, ++n) {
                cp_async_wait<S - 2>();
                __syncthreads();
                issue(n + S - 1);
                const float* wt = ring + (n % S) * P::stage;
                // this stage's rows of [h_below, h_prev] (layer 0: h_prev)
                const float* a = l == 0   ? prv + k0
                               : k0 < H ? cur + (l - 1) * TILE + k0
                                        : prv + l * TILE + (k0 - H);
                a += wrow * HS;
#pragma unroll
                for (int kk = 0; kk < KC; kk += 8) {
                    FragA fa[MT];
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
                        load_a(fa[mt], a + mt * 16 * HS + kk, HS, g, q);
#pragma unroll
                    for (int gt = 0; gt < 4; ++gt)
#pragma unroll
                        for (int ut = 0; ut < UT; ++ut) {
                            FragB fb;
                            load_b(fb, wt + kk * WS + gt * H + wunit + ut * 8, WS, g, q);
#pragma unroll
                            for (int mt = 0; mt < MT; ++mt) mma3(acc[mt][gt][ut], fa[mt], fb);
                        }
                }
            }

            // cell update on the accumulators; h into this step's tile
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int lrow = wrow + mt * 16 + g + 8 * hf;
                    const int row = row_base + lrow;
#pragma unroll
                    for (int ut = 0; ut < UT; ++ut) {
                        const int unit = wunit + ut * 8 + 2 * q;
                        float hv[2], cv[2];
#pragma unroll
                        for (int x = 0; x < 2; ++x) {
                            const int e = 2 * hf + x;
                            const float ig = sigmoid_f32(acc[mt][0][ut][e]);
                            const float fg = sigmoid_f32(acc[mt][1][ut][e]);
                            const float gg = tanhf(acc[mt][2][ut][e]);
                            const float og = sigmoid_f32(acc[mt][3][ut][e]);
                            c[l][mt][ut][e] = fg * c[l][mt][ut][e] + ig * gg;
                            cv[x] = c[l][mt][ut][e];
                            hv[x] = og * tanhf(cv[x]);
                        }
                        const float2 h2 = make_float2(hv[0], hv[1]);
                        const float2 c2 = make_float2(cv[0], cv[1]);
                        *reinterpret_cast<float2*>(cur + l * TILE + lrow * HS + unit) = h2;
                        if (row < R) {
                            if (hseq != nullptr) {
                                const size_t o =
                                    (((static_cast<size_t>(m) * T + t) * L + l) * R + row) * H + unit;
                                *reinterpret_cast<float2*>(hseq + o) = h2;
                                *reinterpret_cast<float2*>(cseq + o) = c2;
                            }
                            if (l == L - 1)
                                *reinterpret_cast<float2*>(
                                    out + ((static_cast<size_t>(m) * R + row) * T + t) * H + unit) = h2;
                            if (t == T - 1) {
                                const size_t o =
                                    ((static_cast<size_t>(m) * L + l) * R + row) * H + unit;
                                *reinterpret_cast<float2*>(h_fin + o) = h2;
                                *reinterpret_cast<float2*>(c_fin + o) = c2;
                            }
                        }
                    }
                }
            // the next stage's __syncthreads orders these h stores before
            // the products that read them
        }
    }
    cp_async_wait<0>();
}

template <int H, int L>
cudaError_t launch(const float* xp, const float* wh0, const float* wxh,
                   const float* bias, float* out, float* h_fin, float* c_fin,
                   float* hseq, float* cseq, int M, int R, int T,
                   cudaStream_t stream) {
    constexpr int smem = FwdPlan<H, L>::smem_bytes;
    cudaError_t err = cudaFuncSetAttribute(
        lstm_fwd_kernel<H, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((R + FwdTile<H>::BR - 1) / FwdTile<H>::BR, M);
    lstm_fwd_kernel<H, L><<<grid, NT, smem, stream>>>(
        xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, R, T);
    return cudaGetLastError();
}

template <int H>
cudaError_t launch_h(int L, const float* xp, const float* wh0, const float* wxh,
                     const float* bias, float* out, float* h_fin, float* c_fin,
                     float* hseq, float* cseq, int M, int R, int T, cudaStream_t s) {
    switch (L) {
        case 1: return launch<H, 1>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        case 2: return launch<H, 2>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        case 3: return launch<H, 3>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        case 4: return launch<H, 4>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        default: return cudaErrorInvalidValue;
    }
}

template <int H>
int smem_h(int L) {
    switch (L) {
        case 1: return FwdPlan<H, 1>::smem_bytes;
        case 2: return FwdPlan<H, 2>::smem_bytes;
        case 3: return FwdPlan<H, 3>::smem_bytes;
        case 4: return FwdPlan<H, 4>::smem_bytes;
        default: return 0;
    }
}

}  // namespace

// C entry point bound with ctypes. Returns a cudaError_t (0 = launched).
// H in {32, 64, 128, 256}; 1 <= L <= 4; hseq/cseq may be null
// (forward-only serving). Every pointer 16-byte aligned.
extern "C" int stmgcn_lstm_fwd(const float* xp, const float* wh0,
                               const float* wxh, const float* bias, float* out,
                               float* h_fin, float* c_fin, float* hseq,
                               float* cseq, int M, int R, int T, int L, int H,
                               void* stream) {
    if (M < 1 || R < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
    if ((hseq == nullptr) != (cseq == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (H) {
        case 32: return static_cast<int>(launch_h<32>(L, xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s));
        case 64: return static_cast<int>(launch_h<64>(L, xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s));
        case 128: return static_cast<int>(launch_h<128>(L, xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s));
        case 256: return static_cast<int>(launch_h<256>(L, xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s));
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Dynamic shared memory (bytes) of one CTA at (L, H); 0 for a shape the
// kernel does not take.
extern "C" int stmgcn_lstm_fwd_smem(int L, int H) {
    switch (H) {
        case 32: return smem_h<32>(L);
        case 64: return smem_h<64>(L);
        case 128: return smem_h<128>(L);
        case 256: return smem_h<256>(L);
        default: return 0;
    }
}

// Rows per CTA at hidden width H (0 for a width the kernel does not take).
extern "C" int stmgcn_lstm_block_rows(int H) {
    switch (H) {
        case 32: return FwdTile<32>::BR;
        case 64: return FwdTile<64>::BR;
        case 128: return FwdTile<128>::BR;
        case 256: return FwdTile<256>::BR;
        default: return 0;
    }
}
