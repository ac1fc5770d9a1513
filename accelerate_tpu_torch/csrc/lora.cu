// Batched gather-matmul for multi-tenant LoRA decode, hand-written for
// Hopper (sm_90a).
//
//   bgmv_bf16  replaces the Pallas TPU kernel
//       accelerate_tpu/ops/lora.py  _bgmv_kernel  (launched by bgmv):
//       per decode slot s, delta[s] = (x[s] . A[ids[s]]) . B[ids[s]], with
//       f32 accumulation, reading only that slot's adapter factors.  Runs
//       for every targeted dense (q_proj and v_proj of every layer) on every
//       decode step of a multi-tenant engine.
//
// Operands (row-major): x [S, d_in] bf16; a_stack [N, d_in, r] and b_stack
// [N, r, d_out] bf16, JAX's [in, out] orientation, slot 0 the all-zero null
// adapter; ids [S] int32; out [S, d_out] bf16.  h = x[s] . A[id] and the
// delta are f32 sums of f32 products, rounded once to bf16 (the TPU kernel's
// preferred_element_type=f32 dots, then astype(x.dtype)).  A row whose id is
// not in [1, N) is written as zeros: id 0 reads the null slot's zeros in the
// TPU kernel, and the caller's where() keeps those rows bitwise the base
// output either way.
//
// Grid: (S, ceil(d_out / 256)); block: 256 threads.  The TPU grid walked
// the slots one by one with the whole d_out row in VMEM; here 16 slots would
// fill 16 of 132 SMs, so d_out is split over blocks and each block
// recomputes h for its slot (d_in * r FMAs: 24.6k at d_in 1536, r 16, from
// L2 after the first block).  Phase 1 (lora_h): thread t owns rows t,
// t + 256, ... of A and eight rank columns at a time, each row's eight
// factors one 16-byte load when r is a multiple of 8, so the loads of a
// thread are independent and a warp reads whole rows; the partial sums
// reduce by warp shuffles, then across warps in shared memory, in a fixed
// order (no atomics, bitwise run to run).  Phase 2: thread t owns one
// output column and walks the r rows of B, neighbouring threads on
// neighbouring columns.
//
// What bounds it on an H100: at the 600m decode shape (16 slots, <= 5
// distinct slots, d_in 1536, r 16, d_out 1536) the work reads ~0.6 MB, a
// bound of ~0.2 us at 3.35 TB/s: the kernel is bound by its launch and its
// two barriers, not by bytes or FLOPs.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (accelerate_tpu_torch/ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lora_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxRank = 64;

__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a_stack,
            const bf16* __restrict__ b_stack, const int* __restrict__ ids,
            bf16* __restrict__ out, int d_in, int r, int d_out, int n_adapters) {
    __shared__ float red[kThreads / 32 * kMaxRank];
    __shared__ float h[kMaxRank];
    const int s = blockIdx.x;
    const int tid = threadIdx.x;
    const int col = blockIdx.y * kThreads + tid;
    const int id = ids[s];
    if (id <= 0 || id >= n_adapters) {   // the same for the whole block
        if (col < d_out) out[(size_t)s * d_out + col] = __float2bfloat16(0.f);
        return;
    }

    // phase 1: h = x[s] . A[id], [d_in] -> [r], f32
    lora_h<kThreads>(x + (size_t)s * d_in, a_stack + (size_t)id * d_in * r, d_in, r, red, h, tid);

    // phase 2: delta[col] = h . B[id][:, col], f32, rounded once
    if (col < d_out) {
        const bf16* b = b_stack + (size_t)id * r * d_out + col;
        float sum = 0.f;
#pragma unroll 8
        for (int k = 0; k < r; ++k) sum = fmaf(h[k], __bfloat162float(b[(size_t)k * d_out]), sum);
        out[(size_t)s * d_out + col] = __float2bfloat16(sum);
    }
}

}  // namespace

extern "C" {

// x [S, d_in], a_stack [N, d_in, r], b_stack [N, r, d_out], ids [S] int32,
// out [S, d_out]; r in [1, 64].  Launches on `stream`, on the tensors'
// device, and leaves the caller's current device as it was.
int bgmv_bf16(int device, const void* x, const void* a_stack, const void* b_stack,
              const void* ids, void* out, int S, int d_in, int r, int d_out, int n_adapters,
              void* stream) {
    if (S <= 0 || d_in <= 0 || d_out <= 0 || n_adapters <= 0 || r < 1 || r > kMaxRank)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(S, (d_out + kThreads - 1) / kThreads);
    if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    bgmv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(a_stack),
        static_cast<const bf16*>(b_stack), static_cast<const int*>(ids),
        static_cast<bf16*>(out), d_in, r, d_out, n_adapters);
    err = cudaGetLastError();
    if (prev != device) {
        const cudaError_t restore = cudaSetDevice(prev);
        if (err == cudaSuccess) err = restore;
    }
    return (int)err;
}

const char* lora_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
