// Fused multi-layer LSTM forward (zero initial state), fp32 or bf16
// storage, for Hopper (sm_90a).
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
//
// bf16 storage (the JAX kernel's numerics at a bf16 storage dtype): x_proj0,
// the weights and biases arrive in bf16 and out, hseq, cseq, h_fin and c_fin
// leave in bf16 (rounded to nearest even); h and c are fp32 in registers,
// and h is rounded to bf16 where it enters a product (`_mm`), which is the
// value the shared h tile holds. Each product is one mma.sync m16n8k16 bf16
// pass with fp32 accumulation, at the 989 TFLOP/s bf16 peak against three
// TF32 passes at 495; the weight ring holds bf16 at half the bytes (a stage
// of 32 rows at H <= 64, as many bytes as fp32's 16) and the h tiles half
// the bytes too. The rows per CTA stay: registers (fp32 accumulators and
// cell states) bound them, not shared memory. The fp32 instantiation is the
// kernel it was.
//
// The xla form (the JAX package's default bf16 LSTM, lstm_backend="xla"):
// the storage type SD of x_proj0, the biases and every output is float32,
// the weights and the h tiles bf16 (P = BF16), so each product is the bf16
// form's one mma.sync pass over h rounded to bf16 where it enters the
// product (the JAX scan's h.astype(bf16)), with fp32 accumulation; h, c,
// out, h_fin, c_fin and the hseq/cseq residuals leave unrounded in fp32. A
// layer >= 1's accumulators start from its fp32 bias and take the h_below
// half of the K = 2H product before the h_prev half, the JAX scan's
// (h_below @ wx + b) + h_prev @ wh. Its bound is the bf16 form's products
// over fp32 traffic: x_proj0 and the residuals at twice the bytes.

#include <cuda_runtime.h>

#include <cstddef>

#include "lstm_mma.cuh"

// The forms this library instantiates, a bit each (1 fp32, 2 bf16, 4 xla):
// the wrapper builds one library per form, so the builds run in parallel
#ifndef STMGCN_LSTM_FORMS
#define STMGCN_LSTM_FORMS 7
#endif

namespace {

using namespace lstm_mma;

// The forward's tiling: 8 warps (16, as the backward sweep takes, measured
// no faster here: its state is lighter and fits 255 registers unspilled)
template <int H, typename P>
using FwdTile = Tile<H, 8, P>;
constexpr int NT = FwdTile<64, F32>::Threads;

template <typename P, int H, int L>
struct FwdPlan {
    using C = FwdTile<H, P>;
    using E = typename P::T;
    static constexpr int hbuf = 2 * L * C::BR * C::HS;  // h tiles, two step parities
    static constexpr int stage = C::KC * C::WS;
    static constexpr int S = ring_stages(sizeof(E) * hbuf, sizeof(E) * stage);
    static constexpr int smem_bytes = sizeof(E) * (hbuf + S * stage);
    static_assert(smem_bytes <= kSmemLimit, "the h tiles and ring fit in shared memory");
    static_assert(sizeof(E) * hbuf % 16 == 0, "the ring starts on a 16-byte boundary");
    static constexpr int Q0 = H / C::KC;      // stages of layer 0's weight
    static constexpr int Q1 = 2 * H / C::KC;  // stages of a layer >= 1 weight
    static constexpr int Q = Q0 + (L - 1) * Q1;  // stages per step
};

// Layouts (M = branches, leading everywhere); weights in the product type
// E, the rest in the storage type SD (E for the fp32 and bf16 forms):
//   xp (M, R, T, 4H); wh0 (M, H, 4H); wxh (M, max(L-1,1), 2H, 4H);
//   bias (M, max(L-1,1), 4H); out (M, R, T, H); h_fin/c_fin (M, L, R, H);
//   hseq/cseq (M, T, L, R, H) or null.
template <typename P, typename SD, int H, int L>
__global__ void __launch_bounds__(NT, 1)
lstm_fwd_kernel(const SD* __restrict__ xp, const typename P::T* __restrict__ wh0,
                const typename P::T* __restrict__ wxh, const SD* __restrict__ bias,
                SD* __restrict__ out, SD* __restrict__ h_fin, SD* __restrict__ c_fin,
                SD* __restrict__ hseq, SD* __restrict__ cseq, int R, int T) {
    using C = FwdTile<H, P>;
    using Pl = FwdPlan<P, H, L>;
    using E = typename P::T;
    constexpr int S = Pl::S, KC = C::KC, HS = C::HS, WS = C::WS, BR = C::BR;
    constexpr int MT = C::MT, UT = C::UT, H4 = 4 * H;
    constexpr int LW = L > 1 ? L - 1 : 1;
    constexpr int TILE = BR * HS;  // one layer's h tile
    constexpr int V = 16 / sizeof(E);  // elements per 16-byte copy
    static_assert(KC * H4 / V % NT == 0, "a stage's copies divide the block");

    extern __shared__ float4 smem4[];
    E* hbuf = reinterpret_cast<E*>(smem4);
    E* ring = hbuf + Pl::hbuf;

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

    const int total = T * Pl::Q;
    // stage n of the weight stream: KC rows of layer l's weight, l and the
    // row offset from n's place in the step
    auto issue = [&](int n) {
        if (n < total) {
            const int p = n % Pl::Q;
            const E* w;
            int k0;
            if (p < Pl::Q0) {
                w = wh0;
                k0 = p * KC;
            } else {
                const int r = p - Pl::Q0;
                w = wxh + static_cast<size_t>(r / Pl::Q1) * 2 * H * H4;
                k0 = (r % Pl::Q1) * KC;
            }
            E* dst = ring + (n % S) * Pl::stage;
            const E* src = w + static_cast<size_t>(k0) * H4;
#pragma unroll
            for (int j = 0; j < KC * H4 / V / NT; ++j) {
                const int i = tid + j * NT;
                const int r = i / (H4 / V), c = (i % (H4 / V)) * V;
                cp_async16(dst + r * WS + c, src + r * H4 + c, true);
            }
        }
        cp_async_commit();
    };

#pragma unroll
    for (int s = 0; s < S - 1; ++s) issue(s);
    for (int i = tid; i < static_cast<int>(sizeof(E) * Pl::hbuf / 4); i += NT)
        reinterpret_cast<uint32_t*>(hbuf)[i] = 0u;  // +0.0 in either type

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
        E* cur = hbuf + (t & 1) * L * TILE;
        const E* prv = hbuf + ((t & 1) ^ 1) * L * TILE;
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
                                    v = load2(xp + (static_cast<size_t>(row) * T + t) * H4 + col);
                            } else {
                                v = load2(bias + (l - 1) * H4 + col);
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
                const E* wt = ring + (n % S) * Pl::stage;
                // this stage's rows of [h_below, h_prev] (layer 0: h_prev)
                const E* a = l == 0   ? prv + k0
                           : k0 < H ? cur + (l - 1) * TILE + k0
                                    : prv + l * TILE + (k0 - H);
                a += wrow * HS;
#pragma unroll
                for (int kk = 0; kk < KC; kk += P::KS) {
                    typename P::FA fa[MT];
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
                        load_a(fa[mt], a + mt * 16 * HS + kk, HS, g, q);
#pragma unroll
                    for (int gt = 0; gt < 4; ++gt)
#pragma unroll
                        for (int ut = 0; ut < UT; ++ut) {
                            typename P::FB fb;
                            load_b(fb, wt + kk * WS + gt * H + wunit + ut * 8, WS, g, q);
#pragma unroll
                            for (int mt = 0; mt < MT; ++mt) P::mma(acc[mt][gt][ut], fa[mt], fb);
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
                        store2(cur + l * TILE + lrow * HS + unit, h2);
                        if (row < R) {
                            if (hseq != nullptr) {
                                const size_t o =
                                    (((static_cast<size_t>(m) * T + t) * L + l) * R + row) * H + unit;
                                store2(hseq + o, h2);
                                store2(cseq + o, c2);
                            }
                            if (l == L - 1)
                                store2(out + ((static_cast<size_t>(m) * R + row) * T + t) * H + unit,
                                       h2);
                            if (t == T - 1) {
                                const size_t o =
                                    ((static_cast<size_t>(m) * L + l) * R + row) * H + unit;
                                store2(h_fin + o, h2);
                                store2(c_fin + o, c2);
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

template <typename P, typename SD, int H, int L>
cudaError_t launch(const void* xp, const void* wh0, const void* wxh, const void* bias,
                   void* out, void* h_fin, void* c_fin, void* hseq, void* cseq, int M,
                   int R, int T, cudaStream_t stream) {
    using E = typename P::T;
    constexpr int smem = FwdPlan<P, H, L>::smem_bytes;
    cudaError_t err = cudaFuncSetAttribute(
        lstm_fwd_kernel<P, SD, H, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((R + FwdTile<H, P>::BR - 1) / FwdTile<H, P>::BR, M);
    lstm_fwd_kernel<P, SD, H, L><<<grid, NT, smem, stream>>>(
        static_cast<const SD*>(xp), static_cast<const E*>(wh0), static_cast<const E*>(wxh),
        static_cast<const SD*>(bias), static_cast<SD*>(out), static_cast<SD*>(h_fin),
        static_cast<SD*>(c_fin), static_cast<SD*>(hseq), static_cast<SD*>(cseq), R, T);
    return cudaGetLastError();
}

template <typename P, typename SD, int H>
cudaError_t launch_h(int L, const void* xp, const void* wh0, const void* wxh,
                     const void* bias, void* out, void* h_fin, void* c_fin, void* hseq,
                     void* cseq, int M, int R, int T, cudaStream_t s) {
    switch (L) {
        case 1: return launch<P, SD, H, 1>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        case 2: return launch<P, SD, H, 2>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        case 3: return launch<P, SD, H, 3>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        case 4: return launch<P, SD, H, 4>(xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        default: return cudaErrorInvalidValue;
    }
}

template <typename P, typename SD>
cudaError_t launch_p(int H, int L, const void* xp, const void* wh0, const void* wxh,
                     const void* bias, void* out, void* h_fin, void* c_fin, void* hseq,
                     void* cseq, int M, int R, int T, cudaStream_t s) {
    switch (H) {
        case 32: return launch_h<P, SD, 32>(L, xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        case 64: return launch_h<P, SD, 64>(L, xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        case 128: return launch_h<P, SD, 128>(L, xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        case 256: return launch_h<P, SD, 256>(L, xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s);
        default: return cudaErrorInvalidValue;
    }
}

template <typename P, int H>
int smem_h(int L) {
    switch (L) {
        case 1: return FwdPlan<P, H, 1>::smem_bytes;
        case 2: return FwdPlan<P, H, 2>::smem_bytes;
        case 3: return FwdPlan<P, H, 3>::smem_bytes;
        case 4: return FwdPlan<P, H, 4>::smem_bytes;
        default: return 0;
    }
}

template <typename P>
int smem_p(int L, int H) {
    switch (H) {
        case 32: return smem_h<P, 32>(L);
        case 64: return smem_h<P, 64>(L);
        case 128: return smem_h<P, 128>(L);
        case 256: return smem_h<P, 256>(L);
        default: return 0;
    }
}

template <typename P, typename SD, int H>
int attrs_h(int L, int* info) {
    switch (L) {
        case 1: return func_attrs(lstm_fwd_kernel<P, SD, H, 1>, info);
        case 2: return func_attrs(lstm_fwd_kernel<P, SD, H, 2>, info);
        case 3: return func_attrs(lstm_fwd_kernel<P, SD, H, 3>, info);
        case 4: return func_attrs(lstm_fwd_kernel<P, SD, H, 4>, info);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename P, typename SD>
int attrs_p(int L, int H, int* info) {
    switch (H) {
        case 32: return attrs_h<P, SD, 32>(L, info);
        case 64: return attrs_h<P, SD, 64>(L, info);
        case 128: return attrs_h<P, SD, 128>(L, info);
        case 256: return attrs_h<P, SD, 256>(L, info);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// C entry point bound with ctypes. Returns a cudaError_t (0 = launched).
// form 0: every operand float32; 1: every operand bfloat16; 2 (the xla
// form): the weights bfloat16, the rest float32. H in {32, 64, 128, 256};
// 1 <= L <= 4; hseq/cseq may be null (forward-only serving). Every pointer
// 16-byte aligned.
extern "C" int stmgcn_lstm_fwd(const void* xp, const void* wh0, const void* wxh,
                               const void* bias, void* out, void* h_fin, void* c_fin,
                               void* hseq, void* cseq, int M, int R, int T, int L, int H,
                               int form, void* stream) {
    if (M < 1 || R < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
    if ((hseq == nullptr) != (cseq == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (form) {
#if STMGCN_LSTM_FORMS & 1
        case 0: return static_cast<int>(launch_p<F32, float>(
                    H, L, xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s));
#endif
#if STMGCN_LSTM_FORMS & 2
        case 1: return static_cast<int>(launch_p<BF16, bf16>(
                    H, L, xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s));
#endif
#if STMGCN_LSTM_FORMS & 4
        case 2: return static_cast<int>(launch_p<BF16, float>(
                    H, L, xp, wh0, wxh, bias, out, h_fin, c_fin, hseq, cseq, M, R, T, s));
#endif
        default: return static_cast<int>(cudaErrorInvalidValue);  // not in this library
    }
}

// Dynamic shared memory (bytes) of one CTA at (L, H) and form (the xla
// form's is the bf16 form's); 0 for a shape the kernel does not take.
extern "C" int stmgcn_lstm_fwd_smem(int L, int H, int form) {
    return form ? smem_p<BF16>(L, H) : smem_p<F32>(L, H);
}

// The compiled instance at (L, H) and form, into info[4] (func_attrs:
// registers, spilled bytes per thread, max threads per block, static shared
// bytes); cudaErrorInvalidValue for a shape or form not in this library.
extern "C" int stmgcn_lstm_fwd_attrs(int L, int H, int form, int* info) {
    switch (form) {
#if STMGCN_LSTM_FORMS & 1
        case 0: return attrs_p<F32, float>(L, H, info);
#endif
#if STMGCN_LSTM_FORMS & 2
        case 1: return attrs_p<BF16, bf16>(L, H, info);
#endif
#if STMGCN_LSTM_FORMS & 4
        case 2: return attrs_p<BF16, float>(L, H, info);
#endif
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// Rows per CTA at hidden width H (0 for a width the kernel does not take);
// the same in both storage types.
extern "C" int stmgcn_lstm_block_rows(int H) {
    switch (H) {
        case 32: return FwdTile<32, F32>::BR;
        case 64: return FwdTile<64, F32>::BR;
        case 128: return FwdTile<128, F32>::BR;
        case 256: return FwdTile<256, F32>::BR;
        default: return 0;
    }
}
