// Batched gather-matmul for multi-tenant LoRA decode, hand-written for
// Hopper (sm_90a): one kernel template, two entry points.
//
//   bgmv_apply_bf16  replaces the Pallas TPU kernel
//       accelerate_tpu/ops/lora.py  _bgmv_kernel  (launched by bgmv) together
//       with the select lora_apply puts around it: per decode slot s,
//       delta[s] = (x[s] . A[ids[s]]) . B[ids[s]] with f32 h and f32 sums,
//       rounded once to bf16, and
//         out[s] = ids[s] > 0 ? bf16(f32(y[s]) + f32(delta[s])) : y[s],
//       bitwise what torch.where(ids > 0, y + delta, y) gives for that
//       delta (id-0 rows are y bitwise, negative zeros included; an id >= N
//       takes a zero delta, then the add).  Runs for every targeted dense
//       (q_proj and v_proj of every layer) on every decode step of a
//       multi-tenant engine: one launch a dense, where the composed route
//       took four (the kernel, the id test, the add, the select).
//   bgmv_bf16  the delta alone (JAX's bgmv): out[s] = delta[s], zeros for
//       an id outside [1, N).
//
// Operands (row-major): x [S, d_in] bf16; y, out [S, d_out] bf16; a_stack
// [N, d_in, r] and b_stack [N, r, d_out] bf16, JAX's [in, out]
// orientation, slot 0 the all-zero null adapter; ids [S] int32.
//
// What bounds it on an H100: at the 600m decode shape (16 slots, <= 5
// distinct ids, d_in 1536, r 16, d_out 1536) the work reads ~0.7 MB, a
// bound of ~0.2 us at 3.35 TB/s; the kernel is bound by its launch and its
// chain of dependent steps: the slot's id, then A[id]'s rows, the
// reductions, the epilogue.  Grid (S, ceil(d_out / 256)), fixed in shape
// whatever the ids, so a CUDA graph can capture it; 256 threads.  The TPU
// grid walked the slots one by one with the whole d_out row in VMEM; here
// d_out is split over blocks and each block takes h for its slot
// (lora_common.cuh:lora_h, the reduction #8 / #9's prologue takes; A[id]
// from L2 after the first block of an adapter).  y's value is fetched
// before h is taken; thread t then owns one output column, walks the r
// rows of B (neighbouring threads on neighbouring columns), adds h .
// B[id][:, col] in f32, rounds once, adds y in f32 and rounds again: one
// launch where the composed route took four.  Grouping the slots of one
// adapter into a block (A[id] read once for them) was measured slower on
// the card at this shape (PERF.md, section 6): its per-block chain of
// reductions grows with the group, where these blocks run side by side;
// fetching B's column before h was measured no faster.  No atomics: the
// output is bitwise the same run to run.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (accelerate_tpu_torch/ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lora_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRank = 64;

template <bool APPLY>
__global__ void __launch_bounds__(kThreads)
bgmv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ y,
            const bf16* __restrict__ a_stack, const bf16* __restrict__ b_stack,
            const int* __restrict__ ids, bf16* __restrict__ out, int d_in, int r, int d_out,
            int n_adapters) {
    __shared__ float red[kThreads / 32 * kMaxRank];
    __shared__ float h[kMaxRank];
    const int s = blockIdx.x;
    const int tid = threadIdx.x;
    const int col = blockIdx.y * kThreads + tid;
    const bool col_ok = col < d_out;
    const size_t o = (size_t)s * d_out + col;
    const int id = ids[s];
    if (id <= 0 || id >= n_adapters) {   // the same for the whole block
        // y bitwise where id <= 0, y + 0 where id >= N (a zero delta, then
        // the add); the delta alone: zeros
        if (col_ok) {
            out[o] = !APPLY ? __float2bfloat16(0.f)
                   : id <= 0 ? y[o]
                             : __float2bfloat16_rn(__bfloat162float(y[o]) + 0.f);
        }
        return;
    }

    // y's value, in flight while h is taken
    const float yv = APPLY && col_ok ? __bfloat162float(y[o]) : 0.f;

    // phase 1: h = x[s] . A[id], [d_in] -> [r], f32
    lora_h<kThreads>(x + (size_t)s * d_in, a_stack + (size_t)id * d_in * r, d_in, r, red, h, tid);

    // phase 2: delta[col] = h . B[id][:, col], f32, rounded once; then y
    if (!col_ok) return;
    const bf16* b = b_stack + (size_t)id * r * d_out + col;
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < r; ++k) sum = fmaf(h[k], __bfloat162float(b[(size_t)k * d_out]), sum);
    const bf16 delta = __float2bfloat16_rn(sum);
    out[o] = APPLY ? __float2bfloat16_rn(yv + __bfloat162float(delta)) : delta;
}

template <bool APPLY>
int launch(int device, const void* x, const void* y, const void* a_stack, const void* b_stack,
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
    bgmv_kernel<APPLY><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(y),
        static_cast<const bf16*>(a_stack), static_cast<const bf16*>(b_stack),
        static_cast<const int*>(ids), static_cast<bf16*>(out), d_in, r, d_out, n_adapters);
    err = cudaGetLastError();
    if (prev != device) {
        const cudaError_t restore = cudaSetDevice(prev);
        if (err == cudaSuccess) err = restore;
    }
    return (int)err;
}

}  // namespace

extern "C" {

// x [S, d_in], a_stack [N, d_in, r], b_stack [N, r, d_out], ids [S] int32,
// out [S, d_out]; r in [1, 64].  Launches on `stream`, on the tensors'
// device, and leaves the caller's current device as it was.
int bgmv_bf16(int device, const void* x, const void* a_stack, const void* b_stack,
              const void* ids, void* out, int S, int d_in, int r, int d_out, int n_adapters,
              void* stream) {
    return launch<false>(device, x, nullptr, a_stack, b_stack, ids, out, S, d_in, r, d_out,
                         n_adapters, stream);
}

// as bgmv_bf16, with y [S, d_out] the base output: out = y + delta where
// the id is > 0, y elsewhere (see above); out must not alias y.
int bgmv_apply_bf16(int device, const void* x, const void* y, const void* a_stack,
                    const void* b_stack, const void* ids, void* out, int S, int d_in, int r,
                    int d_out, int n_adapters, void* stream) {
    return launch<true>(device, x, y, a_stack, b_stack, ids, out, S, d_in, r, d_out, n_adapters,
                        stream);
}

const char* lora_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
