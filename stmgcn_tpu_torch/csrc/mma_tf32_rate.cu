// Issue-rate probe of the tensor-core product the LSTM kernels are built on
// (lstm_mma.cuh), the ceiling of their products on the card: each warp of
// `blocks` CTAs of 8 warps runs `iters` rounds of 16 independent m16n8k8
// TF32 products, one pass (mma_tf32) or three (mma3, the kernels' 3xTF32),
// on operands held in registers. No model path runs it; chip_smoke.py
// builds it beside the kernels and prints the rates.

#include <cuda_runtime.h>

#include "lstm_mma.cuh"

using namespace lstm_mma;

__global__ void __launch_bounds__(kThreads, 1) mma_loop(float* out, int iters, int passes) {
    FragA a;
    FragB b;
    for (int i = 0; i < 4; ++i) split(threadIdx.x * 0.01f + i, a.hi[i], a.lo[i]);
    for (int i = 0; i < 2; ++i) split(threadIdx.x * 0.02f - i, b.hi[i], b.lo[i]);
    float acc[16][4] = {};
    for (int it = 0; it < iters; ++it) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            if (passes == 3)
                mma3(acc[j], a, b);
            else
                mma_tf32(acc[j], a.hi, b.hi);
        }
    }
    float s = 0.0f;
    for (int j = 0; j < 16; ++j)
        for (int e = 0; e < 4; ++e) s += acc[j][e];
    out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the loop live
}

// Milliseconds of one timed launch after a warm-up launch (CUDA events).
extern "C" float stmgcn_mma_tf32_ms(int blocks, int iters, int passes) {
    float* out = nullptr;
    if (cudaMalloc(&out, sizeof(float) * blocks * kThreads) != cudaSuccess) return -1.0f;
    mma_loop<<<blocks, kThreads>>>(out, 16, passes);
    cudaEvent_t start, stop;
    cudaEventCreate(&start);
    cudaEventCreate(&stop);
    cudaEventRecord(start);
    mma_loop<<<blocks, kThreads>>>(out, iters, passes);
    cudaEventRecord(stop);
    cudaEventSynchronize(stop);
    float ms = -1.0f;
    if (cudaGetLastError() == cudaSuccess) cudaEventElapsedTime(&ms, start, stop);
    cudaEventDestroy(start);
    cudaEventDestroy(stop);
    cudaFree(out);
    return ms;
}
