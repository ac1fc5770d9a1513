// Shared by the LoRA kernels: kernel #10 (bgmv_bf16, lora.cu) and the
// prologue of #8 / #9 (fused_bgmv_paged_decode_*, paged_decode.cu: each
// block of a cluster takes a slice of d_in's rows), so that both take
// h = x . A[id] with the same f32 reduction and rounding.
// ops/_build.py hashes every csrc/*.cuh into each library's name, so an
// edit here rebuilds both.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// h[k] = sum_d x[d] * a[d * r + k] for k < r, in f32: thread t takes rows
// t, t + THREADS, ..., eight rank columns at a time (one 16-byte load when
// r is a multiple of 8); the partials reduce by warp shuffles, then across
// warps in shared memory in a fixed order (no atomics, bitwise run to run).
// `red` holds THREADS / 32 * r floats.  Every thread of the block calls it.
template <int THREADS>
__device__ __forceinline__ void lora_h(const bf16* __restrict__ x, const bf16* __restrict__ a,
                                       int d_in, int r, float* red, float* h, int tid) {
    const int lane = tid % 32;
    const int warp = tid / 32;
    const bool vec = r % 8 == 0;
    for (int c0 = 0; c0 < r; c0 += 8) {
        float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int d = tid; d < d_in; d += THREADS) {
            const float xv = __bfloat162float(x[d]);
            const bf16* row = a + (size_t)d * r + c0;
            if (vec) {
                const uint4 v = *reinterpret_cast<const uint4*>(row);
                const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float2 f = __bfloat1622float2(v2[j]);
                    acc[2 * j] = fmaf(xv, f.x, acc[2 * j]);
                    acc[2 * j + 1] = fmaf(xv, f.y, acc[2 * j + 1]);
                }
            } else {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    if (c0 + j < r) acc[j] = fmaf(xv, __bfloat162float(row[j]), acc[j]);
            }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float v = warp_sum(acc[j]);
            if (lane == 0 && c0 + j < r) red[warp * r + c0 + j] = v;
        }
    }
    __syncthreads();
    if (tid < r) {
        float sum = 0.f;
        for (int w = 0; w < THREADS / 32; ++w) sum += red[w * r + tid];
        h[tid] = sum;
    }
    __syncthreads();
}

}  // namespace
