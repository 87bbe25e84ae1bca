// Fused multi-layer LSTM backward (zero initial state), fp32 or bf16
// storage, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` in stmgcn_tpu/ops/pallas_lstm.py
// (launched by `_fused_bwd`): the reverse sweep over t and layers that
// recomputes each step's gate pre-activations from the saved h/c residuals
// (written by fused_lstm_fwd.cu), turns the h/c cotangents into gate
// cotangents (`dgates`), carries dh/dc back through time and down the layers,
// and produces the weight gradients dWh0, dWxh and db.
//
// What bounds it on this card: the tensor cores' issue rate, then the
// weights' trips from L2 and the cell math between the products. At the
// training shape (M=3 branches x 64 samples x 256 nodes = 49,152 rows,
// T=12, L=3, H=64) it does the forward's 96.6 GFLOP three times over (gate
// recompute, dgates @ W^T, hin^T @ dgates): 290 GFLOP, 4.33 ms at the 67
// TFLOP/s fp32 FMA peak, 1.76 ms as three TF32 passes at 495 TFLOP/s,
// against ~2.3 GB of compulsory traffic (0.68 ms at 3.35 TB/s). mma.sync
// itself reaches about two thirds of the 495 TFLOP/s (chip_smoke.py's
// probe, csrc/mma_tf32_rate.cu).
//
// What the design does about it. All three products run on the tensor
// cores (mma.sync m16n8k8 .tf32) in 3xTF32 with fp32 accumulation
// (lstm_mma.cuh). The TPU kernel adds every row block's weight gradient
// into one output block across in-order grid steps; a CUDA grid has no
// order, and one CTA's partial weight gradient does not fit on chip, so
// the work is two phases with no atomics (bitwise-deterministic results):
//
// 1. `lstm_bwd_sweep`: the recurrence, one CTA per (branch, block of BR
//    rows: 64 at H=64, twice the first version's), with the forward's
//    tiling (lstm_mma.cuh `Tile`): a thread's accumulators hold all four
//    gates of its (row, unit) pairs, so the gate cotangents and dh of every
//    layer stay in registers for the whole sweep (dc in thread-private
//    shared memory where it fits, to spare registers). Per (t, l): the
//    recompute hin @ W reads W in row chunks and hin from shared tiles
//    (cp.async-loaded during the previous step's last phase); the cell
//    backward writes dgates to a shared tile; dgates @ W^T reads W in
//    column chunks, transposed in the fragment load, sums each chunk from
//    zero and adds it to dh in fp32, while the dgates tile goes out to dxp
//    (layer 0) or the scratch (layers >= 1) in coalesced 16-byte pieces.
//    Both products read one untransposed copy of W through one ring of 2-4
//    cp.async stages that runs ahead across phases, layers and steps (the
//    stage sequence is data-independent).
// 2. `lstm_bwd_wgrad`: dW = sum_{t,r} hin^T dgates, and db = sum_{t,r}
//    dgates, for every (branch, layer): a split-K product whose CTA owns a
//    64 x 128 tile of dW and a 4,096-row chunk of (t, r), with both
//    operands staged through a 3-stage cp.async ring of 32-row slabs, each
//    slab summed from zero and added to the tile in fp32 (the tensor cores'
//    own accumulation truncates: over a whole chunk that bias broke the
//    1e-5 weight-gradient check). CTAs that share a chunk are neighbours in
//    the grid, so the dgates slab several k-tiles read comes from L2.
// 3. `reduce_partials`: sums the split-K partials in a fixed order.
// Rows past R compute on zeros and are never stored. The cell math is fp32
// with expf/tanhf (no fast-math).
//
// bf16 storage follows the JAX kernel at a bf16 storage dtype: the forward's
// operands, its bf16 residuals hseq/cseq (the gates are recomputed from
// those rounded states) and the cotangents gout/ghfin/gcfin arrive in bf16;
// every product is one mma.sync m16n8k16 bf16 pass with fp32 accumulation,
// its operands rounded to bf16 where `_mm` casts them (h from the bf16
// hin tiles, dgates rounded from the fp32 dgates tile as each fragment is
// loaded); dxp leaves in bf16. The layer >= 1 scratch keeps the unrounded
// fp32 dgates, because db sums them unrounded (`jnp.sum(dgates)`), and
// lstm_bwd_wgrad rounds them where they enter dW's product; dW and db are
// fp32 sums (the wrapper rounds them to the weights' dtype, as
// `_fused_bwd` does). The weight ring and the hin tiles hold bf16 at half
// the bytes; the ring takes 32-row stages at H <= 64 and its depth is
// derived from the bytes again. The fp32 instantiation is the kernel it was.
//
// The xla form (the JAX package's default bf16 LSTM, lstm_backend="xla")
// takes the bf16 form's products over fp32 storage SD: x_proj0, the biases,
// the fp32 residuals hseq/cseq, the cotangents and dxp. The hin tiles hold
// fp32 h, rounded to bf16 as each fragment loads (the forward's rounding, so
// the recomputed gates are the forward's). It rounds where jax.grad of the
// JAX scan rounds, the transposes of the scan's astype(bf16) casts:
// - dgates @ W^T is a product of the unrounded fp32 dgates, taken as two
//   bf16 passes over dgates' halves (split2), summed over every column
//   chunk, then rounded to bf16 once, h_below's part and h_prev's apart,
//   before either joins dh;
// - the weight-gradient pass takes hin rounded to bf16 and dgates' two
//   halves, in chunks that never cross a step (chunks_per_step), so
//   reduce_steps can sum each step's partial over its chunks, round it to
//   bf16 (the recurrent halves always, the input halves of layers >= 1 when
//   the JAX fused scan casts them in the step) and add the steps in fp32,
//   t = T-1 first as the scan's carry does; db is summed unrounded.

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

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The sweep's tiling: 16 warps, each with half the forward's accumulators.
// Its state (dh of every layer, the gate accumulators, the next cell
// states) is heavier than the forward's, and at 8 warps of 255 registers
// the SM has too few warps to hide the fragment loads and the cell math:
// on an H100 SXM (700 W) the sweep took 10.2 ms at 8 warps and 6.5 ms at
// 16 in chip_smoke.py's dense training trace, at the same rows per CTA
// and weight traffic.
template <int H, typename P>
using SweepTile = Tile<H, 16, P>;
constexpr int NT = SweepTile<64, F32>::Threads;

// the xla form: fp32 storage, bf16 products
template <typename P, typename SD>
constexpr bool kXla = sizeof(SD) == 4 && sizeof(typename P::T) == 2;

// Sizes in elements of their own type (the storage type SD for hin, the
// product type E for the ring, fp32 for dgates and dc), shared-memory sums
// in bytes.
template <typename P, typename SD, int H, int L>
struct BwdPlan {
    using C = SweepTile<H, P>;
    using E = typename P::T;
    static constexpr int HT = C::BR * C::HS;  // one hin tile
    static constexpr int hin = 2 * HT;        // h_below, h_prev
    static constexpr int DS = 4 * H + 4;      // dgates tile row stride (fp32)
    static constexpr int dgt = C::BR * DS;
    // dgates @ W^T reads W in column chunks of CC columns x all K rows, as
    // many elements as a row chunk: CC = KC * 4H / K; rows padded by 16 bytes
    static constexpr int CC0 = 4 * C::KC;  // K = H
    static constexpr int CC1 = 2 * C::KC;  // K = 2H
    static constexpr int CP = 16 / sizeof(E);
    static constexpr int stage =
        cmax(C::KC * C::WS, cmax(H * (CC0 + CP), 2 * H * (CC1 + CP)));
    // the cell-state cotangents dc live in shared memory, thread-private
    // (one float per thread per slot, so no bank conflicts), where that
    // leaves room for a ring of 3 or more stages; else in registers. At the
    // training shape (H=64, L=3) registers spill more and the whole
    // backward took 9.06-9.08 ms against 8.76-8.79 ms with dc in shared
    // memory (H100 SXM, 700 W; chip_smoke.py's phase 4 from both trees)
    static constexpr int dc_slots = L * C::MT * C::UT * 4;
    static constexpr int fixed_bytes = sizeof(SD) * hin + 4 * dgt;
    static constexpr bool dc_shared =
        fixed_bytes + 4 * dc_slots * NT + 3 * static_cast<int>(sizeof(E)) * stage <= kSmemLimit;
    static constexpr int dcs = dc_shared ? dc_slots * NT : 0;
    // a step's hin tiles are loaded with its first stage, S-1 stages ahead:
    // inside the previous step's dgates @ W^T stages (at least H / KC), once
    // its recompute has read the tiles it shares with them
    static constexpr int S =
        ring_stages(fixed_bytes + 4 * dcs, sizeof(E) * stage, H / C::KC + 1);
    static constexpr int smem_bytes = fixed_bytes + 4 * dcs + S * sizeof(E) * stage;
    static_assert(smem_bytes <= kSmemLimit, "the sweep's tiles and ring fit in shared memory");
    static_assert(sizeof(SD) * hin % 16 == 0, "dgates and the ring start on 16-byte boundaries");
    static constexpr int Q0 = 2 * H / C::KC;      // stages of layer 0 per step
    static constexpr int Q1 = 4 * H / C::KC;      // of a layer >= 1
    static constexpr int Q = Q0 + (L - 1) * Q1;   // per step
    static_assert(H / C::KC >= S - 1, "hin must be loaded inside the previous step's last phase");
};

// row chunk: KC rows of w (K x 4H) from row k0, stride WS
template <typename P, int H>
__device__ __forceinline__ void load_rows(typename P::T* dst, const typename P::T* w, int k0,
                                          int tid) {
    using C = SweepTile<H, P>;
    constexpr int V = 16 / sizeof(typename P::T);  // elements per 16-byte copy
    constexpr int PR = 4 * H / V;                  // copies per row
    static_assert(C::KC * PR % NT == 0, "copies divide the block");
    const typename P::T* src = w + static_cast<size_t>(k0) * 4 * H;
#pragma unroll
    for (int j = 0; j < C::KC * PR / NT; ++j) {
        const int i = tid + j * NT;
        const int r = i / PR, c = (i % PR) * V;
        cp_async16(dst + r * C::WS + c, src + r * 4 * H + c, true);
    }
}

// column chunk: all K rows x CC columns of w (K x 4H) from column c0,
// stride CC + 16 bytes
template <typename P, int H, int K, int CC>
__device__ __forceinline__ void load_cols(typename P::T* dst, const typename P::T* w, int c0,
                                          int tid) {
    constexpr int V = 16 / sizeof(typename P::T);
    constexpr int PR = CC / V;  // 16-byte pieces per row
    static_assert(K * PR % NT == 0, "pieces divide the block");
#pragma unroll
    for (int j = 0; j < K * PR / NT; ++j) {
        const int i = tid + j * NT;
        const int r = i / PR, c = (i % PR) * V;
        cp_async16(dst + r * (CC + V) + c, w + static_cast<size_t>(r) * 4 * H + c0 + c, true);
    }
}

// Layouts (M = branches, leading everywhere; the weights in the product
// type E, the rest in the storage type SD, which is E but in the xla form):
//   xp (M, R, T, 4H); wh0 (M, H, 4H); wxh (M, max(L-1,1), 2H, 4H);
//   bias (M, max(L-1,1), 4H); hseq/cseq (M, T, L, R, H); gout (M, R, T, H);
//   ghfin/gcfin (M, L, R, H); dxp (M, R, T, 4H); dg (M, T, L-1, R, 4H) fp32.
template <typename P, typename SD, int H, int L>
__global__ void __launch_bounds__(NT, 1)
lstm_bwd_sweep(const SD* __restrict__ xp, const typename P::T* __restrict__ wh0,
               const typename P::T* __restrict__ wxh, const SD* __restrict__ bias,
               const SD* __restrict__ hseq, const SD* __restrict__ cseq,
               const SD* __restrict__ gout, const SD* __restrict__ ghfin,
               const SD* __restrict__ gcfin, SD* __restrict__ dxp,
               float* __restrict__ dg, int R, int T) {
    using C = SweepTile<H, P>;
    using Pl = BwdPlan<P, SD, H, L>;
    using E = typename P::T;
    constexpr int S = Pl::S, KC = C::KC, HS = C::HS, WS = C::WS, BR = C::BR;
    constexpr int MT = C::MT, UT = C::UT, H4 = 4 * H, DS = Pl::DS, HT = Pl::HT;
    constexpr int LW = L > 1 ? L - 1 : 1;
    constexpr int VS = 16 / sizeof(SD);  // storage elements per 16-byte copy
    constexpr bool xla = kXla<P, SD>;

    extern __shared__ float4 smem4[];
    SD* hin = reinterpret_cast<SD*>(smem4);
    float* dgt = reinterpret_cast<float*>(hin + Pl::hin);
    float* dcs = dgt + Pl::dgt;
    E* ring = reinterpret_cast<E*>(dcs + Pl::dcs);

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp / C::WN, wn = warp % C::WN;
    const int g = lane >> 2, q = lane & 3;
    const int m = blockIdx.y;
    const int row_base = blockIdx.x * BR;
    const int wrow = wm * C::RW;
    const int wunit = wn * C::UW;

    xp += static_cast<size_t>(m) * R * T * H4;
    wh0 += static_cast<size_t>(m) * H * H4;
    wxh += static_cast<size_t>(m) * LW * 2 * H * H4;
    bias += static_cast<size_t>(m) * LW * H4;
    hseq += static_cast<size_t>(m) * T * L * R * H;
    cseq += static_cast<size_t>(m) * T * L * R * H;
    gout += static_cast<size_t>(m) * R * T * H;
    dxp += static_cast<size_t>(m) * R * T * H4;
    dg += static_cast<size_t>(m) * T * LW * R * H4;

    auto seq_at = [&](int t, int l, int row) -> size_t {
        return ((static_cast<size_t>(t) * L + l) * R + row) * H;
    };

    const int total = T * Pl::Q;
    // Stage n of the stream: step (t, l) in reverse order, then its recompute
    // row chunks and its dgates @ W^T column chunks. A step's first stage
    // also brings its hin tiles (zeros past R and at t = 0).
    auto issue = [&](int n) {
        if (n < total) {
            const int step_t = n / Pl::Q;
            const int t = T - 1 - step_t;
            const int p = n % Pl::Q;
            int l, r;
            if (p < (L - 1) * Pl::Q1) {
                l = L - 1 - p / Pl::Q1;
                r = p % Pl::Q1;
            } else {
                l = 0;
                r = p - (L - 1) * Pl::Q1;
            }
            E* dst = ring + (n % S) * Pl::stage;
            if (l == 0) {
                if (r < H / KC) load_rows<P, H>(dst, wh0, r * KC, tid);
                else load_cols<P, H, H, Pl::CC0>(dst, wh0, (r - H / KC) * Pl::CC0, tid);
            } else {
                const E* w = wxh + static_cast<size_t>(l - 1) * 2 * H * H4;
                if (r < 2 * H / KC) load_rows<P, H>(dst, w, r * KC, tid);
                else load_cols<P, H, 2 * H, Pl::CC1>(dst, w, (r - 2 * H / KC) * Pl::CC1, tid);
            }
            if (r == 0) {
                SD* hb = hin;
                constexpr int PR = H / VS;
                static_assert(BR * PR % NT == 0, "hin copies divide the block");
#pragma unroll
                for (int j = 0; j < BR * PR / NT; ++j) {
                    const int i = tid + j * NT;
                    const int rr = i / PR, c = (i % PR) * VS;
                    const int row = row_base + rr;
                    const bool live = row < R;
                    const int srow = live ? row : 0;
                    if (l > 0)
                        cp_async16(hb + rr * HS + c, hseq + seq_at(t, l - 1, srow) + c, live);
                    cp_async16(hb + HT + rr * HS + c,
                               hseq + seq_at(t > 0 ? t - 1 : 0, l, srow) + c, live && t > 0);
                }
            }
        }
        cp_async_commit();
    };

#pragma unroll
    for (int s = 0; s < S - 1; ++s) issue(s);

    float dh[L][MT][UT][4];
    float dc_reg[Pl::dc_shared ? 1 : L][MT][UT][4];
    auto dc = [&](int l, int mt, int ut, int e) -> float& {
        if constexpr (Pl::dc_shared)
            return dcs[(((l * MT + mt) * UT + ut) * 4 + e) * NT + tid];
        else
            return dc_reg[l][mt][ut][e];
    };
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int row = row_base + wrow + mt * 16 + g + 8 * hf;
#pragma unroll
                for (int ut = 0; ut < UT; ++ut) {
                    float2 a = make_float2(0.0f, 0.0f), b = a;
                    if (row < R) {
                        const size_t o = ((static_cast<size_t>(m) * L + l) * R + row) * H +
                                         wunit + ut * 8 + 2 * q;
                        a = load2(ghfin + o);
                        b = load2(gcfin + o);
                    }
                    dh[l][mt][ut][2 * hf] = a.x;
                    dh[l][mt][ut][2 * hf + 1] = a.y;
                    dc(l, mt, ut, 2 * hf) = b.x;
                    dc(l, mt, ut, 2 * hf + 1) = b.y;
                }
            }

    int n = 0;  // next stage to consume
    for (int t = T - 1; t >= 0; --t) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int row = row_base + wrow + mt * 16 + g + 8 * hf;
                if (row >= R) continue;
#pragma unroll
                for (int ut = 0; ut < UT; ++ut) {
                    const float2 v =
                        load2(gout + (static_cast<size_t>(row) * T + t) * H + wunit + ut * 8 + 2 * q);
                    dh[L - 1][mt][ut][2 * hf] += v.x;
                    dh[L - 1][mt][ut][2 * hf + 1] += v.y;
                }
            }
#pragma unroll
        for (int li = 0; li < L; ++li) {
            const int l = L - 1 - li;
            const int K = l == 0 ? H : 2 * H;
            const SD* hb = hin;       // h_below
            const SD* hp = hin + HT;  // h_prev

            // this step's cell states, loaded now, read after the recompute
            float2 c_t[MT][2][UT], c_prev[MT][2][UT];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int row = row_base + wrow + mt * 16 + g + 8 * hf;
#pragma unroll
                    for (int ut = 0; ut < UT; ++ut) {
                        const int unit = wunit + ut * 8 + 2 * q;
                        c_t[mt][hf][ut] = c_prev[mt][hf][ut] = make_float2(0.0f, 0.0f);
                        if (row < R) {
                            c_t[mt][hf][ut] = load2(cseq + seq_at(t, l, row) + unit);
                            if (t > 0) c_prev[mt][hf][ut] = load2(cseq + seq_at(t - 1, l, row) + unit);
                        }
                    }
                }

            // (a) recompute the pre-activations, as the forward did
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
                const SD* a = l == 0 ? hp + k0 : k0 < H ? hb + k0 : hp + (k0 - H);
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

            // (b) gate cotangents into the dgates tile
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int lrow = wrow + mt * 16 + g + 8 * hf;
                    const int row = row_base + lrow;
                    const bool live = row < R;
#pragma unroll
                    for (int ut = 0; ut < UT; ++ut) {
                        const int unit = wunit + ut * 8 + 2 * q;
                        const float ct[2] = {c_t[mt][hf][ut].x, c_t[mt][hf][ut].y};
                        const float cp[2] = {c_prev[mt][hf][ut].x, c_prev[mt][hf][ut].y};
                        float d[4][2];
#pragma unroll
                        for (int x = 0; x < 2; ++x) {
                            const int e = 2 * hf + x;
                            const float ig = sigmoid_f32(acc[mt][0][ut][e]);
                            const float fg = sigmoid_f32(acc[mt][1][ut][e]);
                            const float gg = tanhf(acc[mt][2][ut][e]);
                            const float og = sigmoid_f32(acc[mt][3][ut][e]);
                            const float tc = tanhf(ct[x]);
                            const float dhv = dh[l][mt][ut][e];
                            const float d_o = dhv * tc;
                            const float dct = dc(l, mt, ut, e) + dhv * og * (1.0f - tc * tc);
                            const float zero_pad = live ? 1.0f : 0.0f;
                            d[0][x] = zero_pad * (dct * gg * ig * (1.0f - ig));
                            d[1][x] = zero_pad * (dct * cp[x] * fg * (1.0f - fg));
                            d[2][x] = zero_pad * (dct * ig * (1.0f - gg * gg));
                            d[3][x] = zero_pad * (d_o * og * (1.0f - og));
                            dc(l, mt, ut, e) = dct * fg;
                            dh[l][mt][ut][e] = 0.0f;  // (c) accumulates the recurrent part
                        }
#pragma unroll
                        for (int gt = 0; gt < 4; ++gt)
                            *reinterpret_cast<float2*>(dgt + lrow * DS + gt * H + unit) =
                                make_float2(d[gt][0], d[gt][1]);
                    }
                }

            // (c) dh through the weights: dgates @ W^T, W read transposed from
            // its column chunks; h_below's part adds to dh[l-1], h_prev's is
            // dh[l] for step t-1. Meanwhile the dgates tile goes out to dxp
            // (layer 0, in the storage type) or the fp32 scratch
            // lstm_bwd_wgrad reads (layers >= 1) in 16-byte pieces of the
            // tile, whole rows per warp, a share in each stage.
            const int CC = l == 0 ? Pl::CC0 : Pl::CC1;
            const int CCS = CC + 16 / static_cast<int>(sizeof(E));
            SD* out0 = dxp + static_cast<size_t>(t) * H4;
            // xla: h_below's part summed over every chunk before its rounding
            // (h_prev's sums in dh[l], zeroed in (b))
            float below_all[xla ? MT : 1][xla ? UT : 1][4] = {};
            float* out1 = dg + (static_cast<size_t>(t) * LW + (l > 0 ? l - 1 : 0)) * R * H4;
            const int out_stride = (H4 / CC) * NT;  // pieces apart per thread
#pragma unroll 1
            for (int c0 = 0; c0 < H4; c0 += CC, ++n) {
                cp_async_wait<S - 2>();
                __syncthreads();
                issue(n + S - 1);
                for (int p = tid + (c0 / CC) * NT; p < BR * H; p += out_stride) {
                    const int rr = p / H, c = (p % H) * 4;
                    if (row_base + rr < R) {
                        const float4 v = *reinterpret_cast<const float4*>(dgt + rr * DS + c);
                        if (l == 0)
                            store4(out0 + (row_base + rr) * static_cast<size_t>(T) * H4 + c, v);
                        else
                            store4(out1 + (row_base + rr) * static_cast<size_t>(H4) + c, v);
                    }
                }
                const E* wt = ring + (n % S) * Pl::stage;
                // this chunk's sums start from zero and join dh with an fp32
                // add (round to nearest): the tensor cores' own accumulation
                // truncates, and over all 4H columns at once that biases dh
                float below[MT][UT][4] = {}, rec[MT][UT][4] = {};
#pragma unroll
                for (int kk = 0; kk < CC; kk += P::KS) {
                    typename P::FA fa[MT], fl[xla ? MT : 1];
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        const float* src = dgt + (wrow + mt * 16) * DS + c0 + kk;
                        if constexpr (xla)
                            load_a_split(fa[mt], fl[mt], src, DS, g, q);
                        else
                            load_a(fa[mt], src, DS, g, q);
                    }
#pragma unroll
                    for (int ut = 0; ut < UT; ++ut) {
                        typename P::FB fb;
                        load_b_t(fb, wt + (wunit + ut * 8) * CCS + kk, CCS, g, q);
#pragma unroll
                        for (int mt = 0; mt < MT; ++mt) {
                            if constexpr (xla) P::mma(below[mt][ut], fl[mt], fb);
                            P::mma(below[mt][ut], fa[mt], fb);
                        }
                        if (l > 0) {
                            load_b_t(fb, wt + (H + wunit + ut * 8) * CCS + kk, CCS, g, q);
#pragma unroll
                            for (int mt = 0; mt < MT; ++mt) {
                                if constexpr (xla) P::mma(rec[mt][ut], fl[mt], fb);
                                P::mma(rec[mt][ut], fa[mt], fb);
                            }
                        }
                    }
                }
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int ut = 0; ut < UT; ++ut)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            if constexpr (xla)
                                below_all[mt][ut][e] += below[mt][ut][e];
                            else
                                dh[l > 0 ? l - 1 : 0][mt][ut][e] += below[mt][ut][e];
                            if (l > 0) dh[l][mt][ut][e] += rec[mt][ut][e];
                        }
            }
            if constexpr (xla) {  // each product's h cotangent, rounded to bf16
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int ut = 0; ut < UT; ++ut)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            dh[l > 0 ? l - 1 : 0][mt][ut][e] += round_bf16(below_all[mt][ut][e]);
                            if (l > 0) dh[l][mt][ut][e] = round_bf16(dh[l][mt][ut][e]);
                        }
            }
            // the next stage's __syncthreads orders these dgates-tile reads
            // before the tile is rewritten
        }
    }
    cp_async_wait<0>();
}

// Weight gradients: split-K tiles of 64 (k) x 128 (gate column) over
// chunks of kChunk (t, r) rows, 32 rows per ring stage.
constexpr int kWK = 64, kWC = 128, kWN = 32, kWStages = 3;
constexpr int kChunk = 4096;
// slab rows padded by kWPad elements of the slab's type (72 and 136 per row)
constexpr int kWPad = 8;
constexpr int kWSmem = 4 * kWStages * kWN * (kWK + kWPad + kWC + kWPad);  // fp32 slabs, the largest

// One CTA's tile of hin^T dgates over its chunk: A from hseq (storage type
// TA), B from dxp (storage type, layer 0) or the fp32 scratch dg (layers >=
// 1, TB = float); each slab's product summed from zero and added in fp32.
// Split (the xla form): B's fp32 values as two bf16 halves, two passes.
// chunks_per_step 0 cuts the (t, r) rows into kChunk-row chunks across
// steps; > 0 gives each step that many chunks of its own.
template <typename P, typename TA, typename TB, bool Split>
__device__ __forceinline__ void wgrad_body(const TA* __restrict__ hseq,
                                           const TB* __restrict__ bsrc, float* __restrict__ part,
                                           float* red, int M, int R, int T, int L, int H,
                                           int chunks_per_step) {
    constexpr int kWAS = kWK + kWPad, kWBS = kWC + kWPad;
    constexpr int VA = 16 / sizeof(TA), VB = 16 / sizeof(TB);
    extern __shared__ float4 smem4[];
    TA* As = reinterpret_cast<TA*>(smem4);          // [stage][n][k]
    TB* Bs = reinterpret_cast<TB*>(As + kWStages * kWN * kWAS);  // [stage][n][c]
    static_assert(sizeof(TA) * kWStages * kWN * kWAS % 16 == 0, "B slabs 16-byte aligned");
    static_assert(sizeof(TA) * kWStages * kWN * kWAS + sizeof(TB) * kWStages * kWN * kWBS <=
                      kWSmem, "slabs fit the launch's shared memory");
    static_assert(!Split || sizeof(TB) == 4, "split B operands are fp32");

    const int m = blockIdx.z / L;
    const int l = blockIdx.z % L;
    const int H4 = 4 * H;
    const int K = l == 0 ? H : 2 * H;
    const int k_tiles = (K + kWK - 1) / kWK;
    const int c_tiles = H4 / kWC;
    if (static_cast<int>(blockIdx.x) >= k_tiles * c_tiles) return;
    const int kt = blockIdx.x % k_tiles;
    const int ct = blockIdx.x / k_tiles;
    const int LW = L > 1 ? L - 1 : 1;
    long long n_begin, n_end;
    if (chunks_per_step > 0) {  // chunk j of step t
        const int t = blockIdx.y / chunks_per_step, j = blockIdx.y % chunks_per_step;
        const long long r1 = static_cast<long long>(j + 1) * kChunk;
        n_begin = static_cast<long long>(t) * R + static_cast<long long>(j) * kChunk;
        n_end = static_cast<long long>(t) * R + (r1 < R ? r1 : R);
    } else {
        const long long n_total = static_cast<long long>(T) * R;
        n_begin = static_cast<long long>(blockIdx.y) * kChunk;
        n_end = n_begin + kChunk < n_total ? n_begin + kChunk : n_total;
    }
    const int stages = static_cast<int>((n_end - n_begin + kWN - 1) / kWN);
    const bool with_db = l > 0 && kt == 0;

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    const int wk = warp / 4, wc = warp % 4;  // warp tile: 32 k x 32 c

    const TA* hs = hseq + static_cast<size_t>(m) * T * L * R * H;
    // (t, r) of the next slab's first row n = t * R + r, advanced one slab
    // per issue (slabs are issued in order), so no division per load
    int t_next = static_cast<int>(n_begin / R), r_next = static_cast<int>(n_begin % R);
    auto issue = [&](int s) {
        if (s < stages) {
            TA* a_dst = As + (s % kWStages) * kWN * kWAS;
            TB* b_dst = Bs + (s % kWStages) * kWN * kWBS;
            const long long n0 = n_begin + static_cast<long long>(s) * kWN;
            auto row_at = [&](int rr, int& t, int& r) {  // rr < kWN
                t = t_next;
                r = r_next + rr;
                while (r >= R) {
                    r -= R;
                    ++t;
                }
            };
#pragma unroll
            for (int j = 0; j < kWN * kWK / VA / kThreads; ++j) {
                const int i = tid + j * kThreads;
                const int rr = i / (kWK / VA), kc = (i % (kWK / VA)) * VA;
                const int k = kt * kWK + kc;
                const TA* src = hs;
                bool valid = false;
                if (n0 + rr < n_end && k < K) {
                    int t, r;
                    row_at(rr, t, r);
                    const bool below = l > 0 && k < H;
                    const int tt = below ? t : t - 1;
                    const int ll = below ? l - 1 : l;
                    valid = tt >= 0;
                    if (valid)
                        src = hs + ((static_cast<size_t>(tt) * L + ll) * R + r) * H + (k < H ? k : k - H);
                }
                cp_async16(a_dst + rr * kWAS + kc, src, valid);
            }
#pragma unroll
            for (int j = 0; j < kWN * kWC / VB / kThreads; ++j) {
                const int i = tid + j * kThreads;
                const int rr = i / (kWC / VB), cc = (i % (kWC / VB)) * VB;
                const int c = ct * kWC + cc;
                const TB* src = bsrc;
                const bool valid = n0 + rr < n_end;
                if (valid) {
                    int t, r;
                    row_at(rr, t, r);
                    src = l == 0
                        ? bsrc + ((static_cast<size_t>(m) * R + r) * T + t) * H4 + c
                        : bsrc + (((static_cast<size_t>(m) * T + t) * LW + (l - 1)) * R + r) * H4 + c;
                }
                cp_async16(b_dst + rr * kWBS + cc, src, valid);
            }
            r_next += kWN;
            while (r_next >= R) {
                r_next -= R;
                ++t_next;
            }
        }
        cp_async_commit();
    };

    float acc[2][4][4] = {};
    float db_sum = 0.0f;
#pragma unroll
    for (int s = 0; s < kWStages - 1; ++s) issue(s);
    for (int s = 0; s < stages; ++s) {
        cp_async_wait<kWStages - 2>();
        __syncthreads();
        issue(s + kWStages - 1);
        const TA* a = As + (s % kWStages) * kWN * kWAS;
        const TB* b = Bs + (s % kWStages) * kWN * kWBS;
        if (with_db) {  // this thread's column, its half of the slab's rows, in order
            const TB* col = b + (tid >> 7) * (kWN / 2) * kWBS + (tid & 127);
#pragma unroll
            for (int r = 0; r < kWN / 2; ++r) db_sum += to_f32(col[r * kWBS]);
        }
        // the slab's sums start from zero and join acc with an fp32 add
        // (round to nearest): the tensor cores' own accumulation truncates,
        // which over a 4,096-row chunk would bias the sum toward zero
        float part_acc[2][4][4] = {};
#pragma unroll
        for (int kk = 0; kk < kWN; kk += P::KS) {
            typename P::FA fa[2];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
                load_a_t(fa[mt], a + kk * kWAS + wk * 32 + mt * 16, kWAS, g, q);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
                typename P::FB fb, fl;
                if constexpr (Split)
                    load_b_split(fb, fl, b + kk * kWBS + wc * 32 + nt * 8, kWBS, g, q);
                else
                    load_b(fb, b + kk * kWBS + wc * 32 + nt * 8, kWBS, g, q);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    if constexpr (Split) P::mma(part_acc[mt][nt], fa[mt], fl);
                    P::mma(part_acc[mt][nt], fa[mt], fb);
                }
            }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part_acc[mt][nt][e];
    }
    cp_async_wait<0>();

    const size_t dw0 = static_cast<size_t>(M) * H * H4;
    const size_t dwx = L > 1 ? static_cast<size_t>(M) * (L - 1) * 2 * H * H4 : 0;
    const size_t x_total = dw0 + dwx + (L > 1 ? static_cast<size_t>(M) * (L - 1) * H4 : 0);
    float* base = part + blockIdx.y * x_total;
    float* out = base + (l == 0 ? static_cast<size_t>(m) * H * H4
                                : dw0 + (static_cast<size_t>(m) * (L - 1) + (l - 1)) * 2 * H * H4);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int k = kt * kWK + wk * 32 + mt * 16 + g + 8 * hf;
            if (k >= K) continue;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
                *reinterpret_cast<float2*>(out + static_cast<size_t>(k) * H4 + ct * kWC +
                                           wc * 32 + nt * 8 + 2 * q) =
                    make_float2(acc[mt][nt][2 * hf], acc[mt][nt][2 * hf + 1]);
        }
    if (with_db) {
        red[tid] = db_sum;
        __syncthreads();
        if (tid < kWC)
            base[dw0 + dwx + (static_cast<size_t>(m) * (L - 1) + (l - 1)) * H4 + ct * kWC + tid] =
                red[tid] + red[tid + kWC];
    }
}

// Grid: (k-tiles x c-tiles, chunks, M * L); x = ct * k_tiles + kt, so the
// k-tiles that read the same dgates slab are neighbours. The CTA sums
// hin[n, k] * dgates[n, c] over its chunk's rows n = t * R + r and writes
// its tile to part[chunk], laid out as dwh0 (M, H, 4H), dwxh (M, L-1, 2H,
// 4H), then db (M, L-1, 4H); the kt == 0 CTAs of layers >= 1 also sum
// their dgates columns into db.
template <typename P, typename SD>
__global__ void __launch_bounds__(kThreads, 2)
lstm_bwd_wgrad(const SD* __restrict__ hseq, const SD* __restrict__ dxp,
               const float* __restrict__ dg, float* __restrict__ part, int M, int R, int T,
               int L, int H, int chunks_per_step) {
    __shared__ float red[kThreads];
    if constexpr (sizeof(SD) == 4) {
        wgrad_body<P, float, float, kXla<P, SD>>(hseq, blockIdx.z % L == 0 ? dxp : dg, part,
                                                 red, M, R, T, L, H, chunks_per_step);
    } else {
        if (blockIdx.z % L == 0)
            wgrad_body<P, SD, SD, false>(hseq, dxp, part, red, M, R, T, L, H, chunks_per_step);
        else
            wgrad_body<P, SD, float, false>(hseq, dg, part, red, M, R, T, L, H,
                                            chunks_per_step);
    }
}

// out[i] = sum_{p < P} part[p * X + i] in order p = 0, 1, ...; entries below
// s1 go to out0, those in [s1, s2) to out1[i - s1], the rest to out2[i - s2].
__global__ void reduce_partials(const float* __restrict__ part, int P, size_t X,
                                size_t s1, size_t s2, float* __restrict__ out0,
                                float* __restrict__ out1, float* __restrict__ out2) {
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < X;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        float s = 0.0f;
        for (int p = 0; p < P; ++p) s += part[static_cast<size_t>(p) * X + i];
        if (i < s1)
            out0[i] = s;
        else if (i < s2)
            out1[i - s1] = s;
        else
            out2[i - s2] = s;
    }
}

// The xla form's reduction: out[i] = sum over t = T-1, ..., 0 of step t's
// partial (its chunks_per_step chunks summed in order), each rounded to bf16
// where jax.grad of the JAX scan rounds it: dwh0 always; dwxh's rows H..2H
// (the recurrent half) always, rows 0..H (the input half) with flags bit 0
// (the fused scan); db only with bits 0 and 1 (the fused scan's bias a bf16
// shadow). With flags bit 1 (bf16 shadow weights, stochastic rounding) the
// rounded partials' running sum is rounded to bf16 after every add, as the
// scan's bf16 carry. Outputs as reduce_partials'.
__global__ void reduce_steps(const float* __restrict__ part, int T, int chunks_per_step,
                             size_t X, size_t s1, size_t s2, int H, int flags,
                             float* __restrict__ out0, float* __restrict__ out1,
                             float* __restrict__ out2) {
    const bool wx_steps = flags & 1, carry = flags & 2;
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < X;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        bool round_it = i < s1;
        if (i >= s1 && i < s2) {
            const size_t k = ((i - s1) / (4 * static_cast<size_t>(H))) % (2 * H);
            round_it = wx_steps || k >= static_cast<size_t>(H);
        } else if (i >= s2) {
            round_it = wx_steps && carry;
        }
        float total = 0.0f;
        for (int t = T - 1; t >= 0; --t) {
            float s = 0.0f;
            for (int j = 0; j < chunks_per_step; ++j)
                s += part[(static_cast<size_t>(t) * chunks_per_step + j) * X + i];
            total += round_it ? round_bf16(s) : s;
            if (round_it && carry) total = round_bf16(total);
        }
        if (i < s1)
            out0[i] = total;
        else if (i < s2)
            out1[i - s1] = total;
        else
            out2[i - s2] = total;
    }
}

struct Plan {
    int block_rows, row_blocks, chunks, chunks_per_step;
    size_t dg_floats, dw_floats, s1, s2;
};

// xla: the weight-gradient chunks never cross a step
Plan plan(int M, int R, int T, int L, int H, int block_rows, bool xla) {
    Plan p;
    p.block_rows = block_rows;
    p.row_blocks = (R + block_rows - 1) / block_rows;
    const long long n_total = static_cast<long long>(T) * R;
    p.chunks_per_step = xla ? (R + kChunk - 1) / kChunk : 0;
    p.chunks = xla ? T * p.chunks_per_step
                   : static_cast<int>((n_total + kChunk - 1) / kChunk);
    const size_t h4 = 4 * static_cast<size_t>(H);
    p.dg_floats = L > 1 ? static_cast<size_t>(M) * T * (L - 1) * R * h4 : 0;
    p.s1 = static_cast<size_t>(M) * H * h4;
    p.s2 = p.s1 + (L > 1 ? static_cast<size_t>(M) * (L - 1) * 2 * H * h4 : 0);
    p.dw_floats = p.s2 + (L > 1 ? static_cast<size_t>(M) * (L - 1) * h4 : 0);
    return p;
}

int block_rows(int H) {
    switch (H) {
        case 32: return SweepTile<32, F32>::BR;
        case 64: return SweepTile<64, F32>::BR;
        case 128: return SweepTile<128, F32>::BR;
        case 256: return SweepTile<256, F32>::BR;
        default: return 0;
    }
}

bool bad_shape(int M, int R, int T, int L, int H) {
    return block_rows(H) == 0 || M < 1 || R < 1 || T < 1 || L < 1 || L > 4;
}

struct Ptrs {
    const void *xp, *wh0, *wxh, *bias, *hseq, *cseq, *gout, *ghfin, *gcfin;
    void* dxp;
    float* dg;
};

template <typename P, typename SD, int H, int L>
cudaError_t launch_sweep(const Plan& p, const Ptrs& a, int M, int R, int T,
                         cudaStream_t stream) {
    using E = typename P::T;
    constexpr int smem = BwdPlan<P, SD, H, L>::smem_bytes;
    cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_sweep<P, SD, H, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(p.row_blocks, M);
    lstm_bwd_sweep<P, SD, H, L><<<grid, NT, smem, stream>>>(
        static_cast<const SD*>(a.xp), static_cast<const E*>(a.wh0),
        static_cast<const E*>(a.wxh), static_cast<const SD*>(a.bias),
        static_cast<const SD*>(a.hseq), static_cast<const SD*>(a.cseq),
        static_cast<const SD*>(a.gout), static_cast<const SD*>(a.ghfin),
        static_cast<const SD*>(a.gcfin), static_cast<SD*>(a.dxp), a.dg, R, T);
    return cudaGetLastError();
}

template <typename P, typename SD, int H>
cudaError_t sweep_h(int L, const Plan& p, const Ptrs& a, int M, int R, int T, cudaStream_t s) {
    switch (L) {
        case 1: return launch_sweep<P, SD, H, 1>(p, a, M, R, T, s);
        case 2: return launch_sweep<P, SD, H, 2>(p, a, M, R, T, s);
        case 3: return launch_sweep<P, SD, H, 3>(p, a, M, R, T, s);
        default: return launch_sweep<P, SD, H, 4>(p, a, M, R, T, s);
    }
}

template <typename P, typename SD, int H>
int smem_h(int L) {
    switch (L) {
        case 1: return BwdPlan<P, SD, H, 1>::smem_bytes;
        case 2: return BwdPlan<P, SD, H, 2>::smem_bytes;
        case 3: return BwdPlan<P, SD, H, 3>::smem_bytes;
        case 4: return BwdPlan<P, SD, H, 4>::smem_bytes;
        default: return 0;
    }
}

template <typename P, typename SD>
int smem_p(int L, int H) {
    switch (H) {
        case 32: return smem_h<P, SD, 32>(L);
        case 64: return smem_h<P, SD, 64>(L);
        case 128: return smem_h<P, SD, 128>(L);
        case 256: return smem_h<P, SD, 256>(L);
        default: return 0;
    }
}

template <typename P, typename SD, int H>
int attrs_h(int L, int* info) {
    switch (L) {
        case 0: return func_attrs(lstm_bwd_wgrad<P, SD>, info);
        case 1: return func_attrs(lstm_bwd_sweep<P, SD, H, 1>, info);
        case 2: return func_attrs(lstm_bwd_sweep<P, SD, H, 2>, info);
        case 3: return func_attrs(lstm_bwd_sweep<P, SD, H, 3>, info);
        case 4: return func_attrs(lstm_bwd_sweep<P, SD, H, 4>, info);
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

template <typename P, typename SD>
int run(const Ptrs& a, float* dwh0, float* dwxh, float* db, float* part, const Plan& p, int M,
        int R, int T, int L, int H, int flags, cudaStream_t s) {
    cudaError_t err;
    switch (H) {
        case 32: err = sweep_h<P, SD, 32>(L, p, a, M, R, T, s); break;
        case 64: err = sweep_h<P, SD, 64>(L, p, a, M, R, T, s); break;
        case 128: err = sweep_h<P, SD, 128>(L, p, a, M, R, T, s); break;
        default: err = sweep_h<P, SD, 256>(L, p, a, M, R, T, s); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);

    err = cudaFuncSetAttribute(lstm_bwd_wgrad<P, SD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int max_tiles = ((2 * H + kWK - 1) / kWK) * (4 * H / kWC);
    const dim3 wgrid(max_tiles, p.chunks, M * L);
    lstm_bwd_wgrad<P, SD><<<wgrid, kThreads, kWSmem, s>>>(
        static_cast<const SD*>(a.hseq), static_cast<const SD*>(a.dxp), a.dg, part, M, R, T, L,
        H, p.chunks_per_step);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    const size_t rblocks = (p.dw_floats + kThreads - 1) / kThreads;
    const int rgrid = rblocks < 2048 ? static_cast<int>(rblocks) : 2048;
    if (p.chunks_per_step > 0)
        reduce_steps<<<rgrid, kThreads, 0, s>>>(part, T, p.chunks_per_step, p.dw_floats, p.s1,
                                                p.s2, H, flags, dwh0, dwxh, db);
    else
        reduce_partials<<<rgrid, kThreads, 0, s>>>(part, p.chunks, p.dw_floats, p.s1, p.s2,
                                                   dwh0, dwxh, db);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch the backward needs (layer >= 1 dgates, split-K
// weight-gradient partials) in form 0, 1 or 2 (stmgcn_lstm_bwd's); the
// wrapper allocates them.
extern "C" size_t stmgcn_lstm_bwd_workspace(int M, int R, int T, int L, int H, int form) {
    if (bad_shape(M, R, T, L, H)) return 0;
    const Plan p = plan(M, R, T, L, H, block_rows(H), form == 2);
    return p.dg_floats + p.chunks * p.dw_floats;
}

// Dynamic shared memory (bytes) of one sweep CTA at (L, H) and form, and of
// one weight-gradient CTA (L = 0); 0 for a shape the kernel does not take.
extern "C" int stmgcn_lstm_bwd_smem(int L, int H, int form) {
    if (L == 0) return kWSmem;
    switch (form) {
        case 0: return smem_p<F32, float>(L, H);
        case 1: return smem_p<BF16, bf16>(L, H);
        case 2: return smem_p<BF16, float>(L, H);
        default: return 0;
    }
}

// The compiled sweep instance at (L, H) and form, or the weight-gradient
// kernel (L = 0), into info[4] (func_attrs: registers, spilled bytes per
// thread, max threads per block, static shared bytes); cudaErrorInvalidValue
// for a shape or form not in this library.
extern "C" int stmgcn_lstm_bwd_attrs(int L, int H, int form, int* info) {
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

// C entry point bound with ctypes. Returns a cudaError_t (0 = launched).
// form 0: xp .. gcfin and dxp float32; 1: bfloat16; 2 (the xla form): the
// weights bfloat16, the rest float32, with reduce_steps' flags (bit 0: round
// each step's layer >= 1 input-weight partial, the JAX fused scan; bit 1:
// the weights are a bf16 shadow, so the rounded sums run in bf16). The
// weight gradients dwh0, dwxh, db and the workspace fp32. H in {32, 64, 128, 256},
// 1 <= L <= 4; every pointer 16-byte aligned. For L == 1, dwxh and db are
// placeholders that are not written.
extern "C" int stmgcn_lstm_bwd(const void* xp, const void* wh0, const void* wxh,
                               const void* bias, const void* hseq, const void* cseq,
                               const void* gout, const void* ghfin, const void* gcfin,
                               void* dxp, float* dwh0, float* dwxh, float* db,
                               float* workspace, int M, int R, int T, int L, int H, int form,
                               int flags, void* stream) {
    if (bad_shape(M, R, T, L, H) || form < 0 || form > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Plan p = plan(M, R, T, L, H, block_rows(H), form == 2);
    const Ptrs a{xp, wh0, wxh, bias, hseq, cseq, gout, ghfin, gcfin, dxp, workspace};
    float* part = workspace + p.dg_floats;
    switch (form) {
#if STMGCN_LSTM_FORMS & 1
        case 0: return run<F32, float>(a, dwh0, dwxh, db, part, p, M, R, T, L, H, 0, s);
#endif
#if STMGCN_LSTM_FORMS & 2
        case 1: return run<BF16, bf16>(a, dwh0, dwxh, db, part, p, M, R, T, L, H, 0, s);
#endif
#if STMGCN_LSTM_FORMS & 4
        case 2: return run<BF16, float>(a, dwh0, dwxh, db, part, p, M, R, T, L, H, flags, s);
#endif
        default: return static_cast<int>(cudaErrorInvalidValue);  // not in this library
    }
}
