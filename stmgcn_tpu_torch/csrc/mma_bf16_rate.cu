// Issue-rate probe of the bf16 tensor-core product the kernels' bf16 forms
// are built on (lstm_mma.cuh `mma_bf16`), the ceiling of their products on
// the card: each warp of `blocks` CTAs of 8 warps runs `iters` rounds of 16
// independent mma.sync m16n8k16 bf16 products with fp32 accumulation, on
// operands held in registers. No model path runs it; chip_smoke.py builds it
// beside the kernels and prints the rate against the 989 TFLOP/s bf16 peak.

#include <cuda_runtime.h>

#include "lstm_mma.cuh"

using namespace lstm_mma;

__global__ void __launch_bounds__(kThreads, 1) mma_bf16_loop(float* out, int iters) {
    FragA16 a;
    FragB16 b;
    for (int i = 0; i < 4; ++i) a.r[i] = pack(threadIdx.x * 0.01f + i, threadIdx.x * 0.03f - i);
    for (int i = 0; i < 2; ++i) b.r[i] = pack(threadIdx.x * 0.02f - i, 0.5f + i);
    float acc[16][4] = {};
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < 16; ++j) mma_bf16(acc[j], a.r, b.r);
    }
    float s = 0.0f;
    for (int j = 0; j < 16; ++j)
        for (int e = 0; e < 4; ++e) s += acc[j][e];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the loop live
}

// Milliseconds of one timed launch after a warm-up launch (CUDA events).
extern "C" float stmgcn_mma_bf16_ms(int blocks, int iters) {
    float* out = nullptr;
    if (cudaMalloc(&out, sizeof(float) * blocks * kThreads) != cudaSuccess) return -1.0f;
    mma_bf16_loop<<<blocks, kThreads>>>(out, 16);
    cudaEvent_t start, stop;
    cudaEventCreate(&start);
    cudaEventCreate(&stop);
    cudaEventRecord(start);
    mma_bf16_loop<<<blocks, kThreads>>>(out, iters);
    cudaEventRecord(stop);
    cudaEventSynchronize(stop);
    float ms = -1.0f;
    if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, start, stop);
    cudaEventDestroy(start);
    cudaEventDestroy(stop);
    cudaFree(out);
    return ms;
}
