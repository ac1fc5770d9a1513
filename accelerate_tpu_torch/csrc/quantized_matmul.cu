// Weight-only int8 matmul (W8A16) for quantized serving, hand-written for
// Hopper (sm_90a).
//
// Two entry points, one per Pallas TPU kernel of
// accelerate_tpu/ops/quantized_matmul.py:
//
//   qmm_tiled   replaces _qmm_kernel (the tiled call of quantized_matmul):
//       out[m, f] = sum_h bf16(x[m, h]) * bf16(f32(code[h, f]) * s[f / qb, h]),
//       f32 accumulation: every dense of a quantized model at m > 8 rows
//       (the 16-slot decode step, prefill chunks);
//   qmm_wholef  replaces _qmm_wholef_kernel (the whole-F decode call, m <= 8):
//       out[m, f] = sum_h bf16(f32(x[m, h]) * s[f / qb, h]) * code[h, f],
//       the scale folded into x, f32 accumulation.
//
// Operands (the JAX k2d layouts): x [M, H] bf16, codes [H, F] int8 row-major
// (F contiguous), scales [F / qb, H] f32, qb a multiple of 128 dividing F,
// H a multiple of 8; out [M, F] bf16 or f32.
//
// What bounds them on an H100: the codes are read once at one byte per
// weight, so at decode (m <= 64) both are bound by HBM bytes (a 1536 x 4096
// dense: 6.3 MB, ~1.9 us at 3.35 TB/s); at a 512-row prefill chunk the
// tiled kernel does 2 * 512 flops per code byte and is bound by the tensor
// cores.  The TPU kernels walked K serially and kept the sum in VMEM; here
// H may be split over blocks so a call fills the 132 SMs.
//
// #11, qmm_tiled: tiles of BM rows by 128 output columns, K tiles of 64;
// the caller picks BM from m: 16 (m <= 16) or 64 (m <= 64) at decode
// width, 128 at prefill width.  A producer warp keeps six K tiles in
// flight by TMA (x bf16 and the codes in the 128-byte swizzle, the K tile's
// scales), completing on mbarriers; two consumer warpgroups own 64 output
// columns each.  The product runs transposed, out^T = W^T x^T: the
// dequantized weight is the register A operand of wgmma m64nBMk16 and x
// the K-major shared-memory B operand, so the dequantized weight never
// goes to shared memory (no proxy fence, no barrier between the
// warpgroups).  Each thread loads its codes with ldmatrix.trans (two
// adjacent columns' codes at the fragment's k pairs, in one word) and
// converts them to bf16(f32(code) * s): a byte permute into the f32 bit
// pattern 2^23 + code + 128, a subtract, one multiply, one rounding.  The
// scale varies along K, so it cannot move to the epilogue.  The next K
// tile's conversion runs while this tile's wgmma does, into other
// registers: the fragments of the product in flight are pinned until its
// wgmma.wait_group (hopper::fence_operand), else the compiler may reuse
// them for the next tile's and the tensor cores read a half-converted
// operand whenever the product runs late (two blocks on one SM).
// With H split (at most 8 slices), each block writes its f32 partial tile
// to a scratch and counts its arrival on the tile's int32 counter; the last
// block to arrive adds the slices in slice order (bitwise equal run to run,
// whichever block is last), writes the output and sets the counter back to
// 0, so one launch does the whole product and a CUDA graph can replay it.
// #12: CUDA-core FMAs.  A block owns 256 columns and a slice of H; each of
// its 8 warps reads rows of codes 8 bytes per thread (256 contiguous bytes
// per warp and row), multiplies by the block's staged bf16(x * s) and sums
// in registers; the 8 warps are added in shared memory in a fixed order,
// and a second pass adds the slices of H in slice order.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (accelerate_tpu_torch/ops/_build.py)

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void store2(void* out, size_t idx, float a, float b, bool f32) {
    if (f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(a, b);
    } else {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + idx) =
            __floats2bfloat162_rn(a, b);
    }
}

__device__ __forceinline__ void store1(void* out, size_t idx, float a, bool f32) {
    if (f32) {
        static_cast<float*>(out)[idx] = a;
    } else {
        static_cast<bf16*>(out)[idx] = __float2bfloat16_rn(a);
    }
}

// -- kernel #11: tensor-core W8A16 (wgmma) ----------------------------------

constexpr int QMM_BF = 128;            // output columns (F) per tile, inside one q-block
constexpr int QMM_BK = 64;             // rows of H per K tile
constexpr int QMM_THREADS = 288;       // two consumer warpgroups and a producer warp
constexpr int QMM_STAGES = 6;          // K tiles in flight
constexpr int QMM_MAX_SPLITS = 8;      // slices of H, all read at once by the sum

// BM output rows (tokens) per tile: 16, 64 or 128
template <int BM>
struct QmmPlan {
    static constexpr int kXBytes = BM * 128;                // bf16 x tile, 128-byte swizzle
    static constexpr int kCBytes = QMM_BK * QMM_BF;         // int8 codes, 128-byte swizzle
    static constexpr int kSBytes = QMM_BK * 4;              // the K tile's scales
    static constexpr uint32_t kTx = kXBytes + kCBytes + kSBytes;
    static constexpr int kStageBytes = (kXBytes + kCBytes + kSBytes + 1023) / 1024 * 1024;
    static constexpr int kBar = QMM_STAGES * kStageBytes;   // full[stages], empty[stages]
    static constexpr size_t kBytes = (size_t)kBar + 16 * QMM_STAGES + 1024;
};

__device__ __forceinline__ void store4(void* out, size_t idx, float4 v, bool f32) {
    if (f32) {
        *reinterpret_cast<float4*>(static_cast<float*>(out) + idx) = v;
    } else {
        uint2 p;
        p.x = hopper::pack_bf16(v.x, v.y);
        p.y = hopper::pack_bf16(v.z, v.w);
        *reinterpret_cast<uint2*>(static_cast<bf16*>(out) + idx) = p;
    }
}

// f32(code) of byte b of a word whose bytes were xor-ed with 0x80: exact,
// through the f32 bit pattern 2^23 + (code + 128) (a byte permute, no
// int-to-float conversion)
__device__ __forceinline__ float code_at(uint32_t biased, int b) {
    return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + b)) - 8388736.f;
}

// The weight is the register A operand of out^T = W^T x^T: A's row r of
// warp wl of warpgroup wg is output column f = 64 wg + 16 wl + 2 (r % 8) +
// r / 8 (a permutation inside each 16 rows, so that a thread's two rows
// are two adjacent columns).  ldmatrix.trans on the codes as 16-bit pairs
// then hands each thread the codes of f and f + 1 at rows h0 + 2t and
// h0 + 2t + 1 in one word, exactly the fragment's k pairs: one
// ldmatrix.x4 brings two k16 steps.  Each step's fragment is
// bf16(f32(code[h][f]) * s[h]) at rows h = h0 + 2t, +1, +8, +9.
__device__ __forceinline__ void weight_fragments(const unsigned char* cs, const float* ss,
                                                 int chunk, int lane, int t4,
                                                 uint32_t (*a)[4]) {
#pragma unroll
    for (int q = 0; q < QMM_BK / 32; ++q) {
        const int row = 32 * q + lane;   // lanes 8i..8i+7 give matrix i's rows
        uint32_t w[4];
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
                     : "r"(hopper::smem_u32(cs + row * 128 + ((chunk ^ (row & 7)) << 4))));
#pragma unroll
        for (int step = 0; step < 2; ++step) {
            const int h = 32 * q + 16 * step + 2 * t4;
            const uint32_t lo = w[2 * step] ^ 0x80808080u;       // rows h, h + 1
            const uint32_t hi = w[2 * step + 1] ^ 0x80808080u;   // rows h + 8, h + 9
            const float2 s01 = *reinterpret_cast<const float2*>(ss + h);
            const float2 s89 = *reinterpret_cast<const float2*>(ss + h + 8);
            uint32_t* f = a[2 * q + step];
            f[0] = hopper::pack_bf16(code_at(lo, 0) * s01.x, code_at(lo, 2) * s01.y);  // f
            f[1] = hopper::pack_bf16(code_at(lo, 1) * s01.x, code_at(lo, 3) * s01.y);  // f + 1
            f[2] = hopper::pack_bf16(code_at(hi, 0) * s89.x, code_at(hi, 2) * s89.y);
            f[3] = hopper::pack_bf16(code_at(hi, 1) * s89.x, code_at(hi, 3) * s89.y);
        }
    }
}

// consumers: warpgroup wg owns output columns n0 + 64 wg .. + 63 of the
// tile's BM rows; its weight fragments come straight from the codes.  The
// tile goes to `out`, or with H split to this slice's f32 partial tile
// `dst`.
template <int BM>
__device__ __forceinline__ void consume(const unsigned char* smem, uint32_t sbase,
                                        uint32_t full0, uint32_t empty0, int nkt, void* out,
                                        float* dst, int M, int F, int n0, int m0, int out_f32) {
    using L = QmmPlan<BM>;
    constexpr int S = QMM_STAGES;
    const int tid = threadIdx.x;
    const int wg = tid >> 7;
    const int wl = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int chunk = wg * 4 + wl;     // the 16-byte chunk of a code row holding f, f + 1
    const int f = n0 + 16 * chunk + 2 * g;

    float acc[BM / 2];
#pragma unroll
    for (int e = 0; e < BM / 2; ++e) acc[e] = 0.f;

    // weight fragments of this K tile and of the next: the next tile's
    // conversion runs while this tile's product is on the tensor cores
    uint32_t a[QMM_BK / 16][4], a_next[QMM_BK / 16][4];
    auto convert = [&](int kt, uint32_t (*frag)[4]) {
        const int st = kt % S;
        hopper::mbar_wait(full0 + 8 * st, (kt / S) & 1);
        const unsigned char* cs = smem + st * L::kStageBytes + L::kXBytes;
        weight_fragments(cs, reinterpret_cast<const float*>(cs + L::kCBytes), chunk, lane, t4,
                         frag);
    };
    convert(0, a);
    for (int kt = 0; kt < nkt; ++kt) {
        const int st = kt % S;
        const uint32_t xs = sbase + st * L::kStageBytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QMM_BK / 16; ++kk)
            hopper::wgmma_rs<BM>(acc, a[kk], hopper::sw128_desc(xs + kk * 32));
        hopper::wgmma_commit();
        if (kt + 1 < nkt) convert(kt + 1, a_next);
        hopper::wgmma_wait<0>();
        // the products read a and wrote acc until the wait: their registers
        // stay theirs until here, so a_next's conversion cannot take them
#pragma unroll
        for (int kk = 0; kk < QMM_BK / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) hopper::fence_operand(a[kk][e]);
#pragma unroll
        for (int e = 0; e < BM / 2; ++e) hopper::fence_operand(acc[e]);
        // this tile's x and codes are read: its stage is free
        if (lane == 0) hopper::mbar_arrive(empty0 + 8 * st);
#pragma unroll
        for (int kk = 0; kk < QMM_BK / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) a[kk][e] = a_next[kk][e];
    }

    // acc[4j + 0, 1]: out[m0 + 8j + 2t, + 1][f]; acc[4j + 2, 3]: the same at f + 1
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int row = m0 + 8 * j + 2 * t4 + e;
            if (row >= M) continue;
            const float lo = acc[4 * j + e], hi = acc[4 * j + 2 + e];
            if (dst != nullptr) {
                *reinterpret_cast<float2*>(dst + (size_t)row * F + f) = make_float2(lo, hi);
            } else {
                store2(out, (size_t)row * F + f, lo, hi, out_f32);
            }
        }
    }
}

// The H split's slices are blockIdx.z: with more than one, each block
// writes its f32 partial tile to `partial` [splits, M, F] and counts its
// arrival on the tile's int32 counter; the last block to arrive adds the
// slices in slice order and sets the counter back to 0.
template <int BM>
__global__ void __launch_bounds__(QMM_THREADS)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_codes,
                 const __grid_constant__ CUtensorMap tm_scales, void* __restrict__ out,
                 float* __restrict__ partial, int* __restrict__ counters, int M, int H, int F,
                 int qblock, int k_tiles_per_split, int out_f32) {
    using L = QmmPlan<BM>;
    constexpr int S = QMM_STAGES;

    const int n0 = blockIdx.x * QMM_BF;
    const int m0 = blockIdx.y * BM;
    const int split = blockIdx.z;
    const int splits = gridDim.z;
    const int k_begin = split * k_tiles_per_split * QMM_BK;
    const int nkt = min(k_tiles_per_split, (H - k_begin + QMM_BK - 1) / QMM_BK);
    const int tid = threadIdx.x;

    extern __shared__ unsigned char smem_raw[];
    __shared__ int last_block;
    // the swizzled tiles need 1024-byte aligned shared addresses
    unsigned char* smem =
        smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
    const uint32_t sbase = hopper::smem_u32(smem);
    const uint32_t full0 = sbase + L::kBar;         // TMA landed: one arrival + bytes
    const uint32_t empty0 = full0 + 8 * S;          // stage read: one arrival per consumer warp
    if (tid == 0) {
        for (int st = 0; st < S; ++st) {
            hopper::mbar_init(full0 + 8 * st, 1);
            hopper::mbar_init(empty0 + 8 * st, 8);
        }
        hopper::mbar_init_fence();
    }
    __syncthreads();

    if (tid >= 256) {
        // producer: x, the codes and their scales of each K tile by TMA,
        // S tiles ahead of the consumers
        if (tid == 256) {
            const int fb = n0 / qblock;
            for (int kt = 0; kt < nkt; ++kt) {
                const int st = kt % S;
                if (kt >= S) hopper::mbar_wait(empty0 + 8 * st, ((kt / S) - 1) & 1);
                const uint32_t xs = sbase + st * L::kStageBytes;
                const uint32_t full = full0 + 8 * st;
                const int k0 = k_begin + kt * QMM_BK;
                hopper::mbar_arrive_expect_tx(full, L::kTx);
                hopper::tma_load_2d(xs, &tm_x, full, k0, m0);
                hopper::tma_load_2d(xs + L::kXBytes, &tm_codes, full, n0, k0);
                hopper::tma_load_2d(xs + L::kXBytes + L::kCBytes, &tm_scales, full, k0, fb);
            }
        }
        return;
    }
    float* dst = splits > 1 ? partial + (size_t)split * M * F : nullptr;
    consume<BM>(smem, sbase, full0, empty0, nkt, out, dst, M, F, n0, m0, out_f32);
    if (dst == nullptr) return;

    // H split: the last block of this output tile adds the slices in
    // order, every slice's load of a position in flight at once
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    __threadfence();
    hopper::named_barrier(1, 256);
    if (tid == 0) last_block = atomicAdd(counters + tile, 1) == splits - 1;
    hopper::named_barrier(1, 256);
    if (!last_block) return;
    __threadfence();
    const int positions = min(BM, M - m0) * (QMM_BF / 4);
    for (int p = tid; p < positions; p += 256) {
        const size_t off = (size_t)(m0 + p / (QMM_BF / 4)) * F + n0 + (p % (QMM_BF / 4)) * 4;
        float4 v[QMM_MAX_SPLITS];
#pragma unroll
        for (int sp = 0; sp < QMM_MAX_SPLITS; ++sp)
            if (sp < splits)
                v[sp] = __ldcg(reinterpret_cast<const float4*>(partial + (size_t)sp * M * F + off));
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int sp = 0; sp < QMM_MAX_SPLITS; ++sp) {
            if (sp < splits) {
                sum.x += v[sp].x;
                sum.y += v[sp].y;
                sum.z += v[sp].z;
                sum.w += v[sp].w;
            }
        }
        store4(out, off, sum, out_f32);
    }
    if (tid == 0) counters[tile] = 0;
}

// -- kernel #12: whole-F decode ------------------------------------------

constexpr int WF_THREADS = 256;  // 8 warps = 8 row groups
constexpr int WF_COLS = 256;     // 32 lanes x 8 columns
constexpr int WF_CHUNK = 64;     // rows of H staged at a time (8 per warp)
constexpr int WF_XS = WF_CHUNK;  // per (q-block, row of x) stride of the staged bf16(x * s)

template <int M>
__global__ void __launch_bounds__(WF_THREADS)
qmm_wholef_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ codes,
                  const float* __restrict__ scales, void* __restrict__ out,
                  float* __restrict__ partial, int H, int F, int qblock,
                  int rows_per_split, int out_f32) {
    // xs[j][m][r] = bf16(f32(x[m][h0 + r]) * s[fb0 + j][h0 + r]), j = the
    // tile's first or second q-block; the +1 puts the two in other banks
    constexpr int XSJ = M * WF_XS + 1;
    __shared__ float xs[2 * XSJ];
    __shared__ __align__(16) float red[8][WF_COLS];

    const int n0 = blockIdx.x * WF_COLS;
    const int split = blockIdx.y;
    const int h_begin = split * rows_per_split;
    const int h_end = min(H, h_begin + rows_per_split);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int col = n0 + lane * 8;
    const bool col_ok = col < F;
    const int fb0 = n0 / qblock;
    const int nfb = F / qblock;
    const int j = col_ok ? col / qblock - fb0 : 0;

    float acc[M][8];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;

    for (int h0 = h_begin; h0 < h_end; h0 += WF_CHUNK) {
        const int rows = min(WF_CHUNK, h_end - h0);
        __syncthreads();
        for (int i = tid; i < 2 * M * WF_CHUNK; i += WF_THREADS) {
            const int jj = i / (M * WF_CHUNK);
            const int m = (i / WF_CHUNK) % M;
            const int r = i % WF_CHUNK;
            float v = 0.f;
            if (r < rows && fb0 + jj < nfb) {
                const float xv = __bfloat162float(x[(size_t)m * H + h0 + r]);
                v = __bfloat162float(__float2bfloat16_rn(xv * scales[(size_t)(fb0 + jj) * H + h0 + r]));
            }
            xs[jj * XSJ + m * WF_XS + r] = v;
        }
        __syncthreads();
        if (!col_ok) continue;
        uint2 raw[WF_CHUNK / 8];
#pragma unroll
        for (int i = 0; i < WF_CHUNK / 8; ++i) {
            const int r = warp * (WF_CHUNK / 8) + i;
            raw[i] = r < rows ? __ldg(reinterpret_cast<const uint2*>(codes + (size_t)(h0 + r) * F + col))
                              : make_uint2(0u, 0u);
        }
#pragma unroll
        for (int i = 0; i < WF_CHUNK / 8; ++i) {
            const int r = warp * (WF_CHUNK / 8) + i;
            const int8_t* b = reinterpret_cast<const int8_t*>(&raw[i]);
            float cf[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) cf[c] = (float)b[c];
#pragma unroll
            for (int m = 0; m < M; ++m) {
                const float xv = xs[j * XSJ + m * WF_XS + r];
#pragma unroll
                for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(xv, cf[c], acc[m][c]);
            }
        }
    }

    // the 8 warps' sums, added in a fixed order, one output row at a time
#pragma unroll
    for (int m = 0; m < M; ++m) {
        __syncthreads();
        float4* dst = reinterpret_cast<float4*>(&red[warp][lane * 8]);
        dst[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        dst[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
        __syncthreads();
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += red[w][tid];
        const int f = n0 + tid;
        if (f < F) {
            if (partial != nullptr) {
                partial[((size_t)split * M + m) * F + f] = sum;
            } else {
                store1(out, (size_t)m * F + f, sum, out_f32);
            }
        }
    }
}

// out = sum over the slices of H of the partial sums, in slice order
__global__ void reduce_splits_kernel(const float* __restrict__ partial, void* __restrict__ out,
                                     int splits, size_t n, int out_f32) {
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x) {
        float s = 0.f;
        for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * n + i];
        store1(out, i, s, out_f32);
    }
}

cudaError_t reduce_splits(const float* partial, void* out, int splits, size_t n, int out_f32,
                          cudaStream_t stream) {
    const int threads = 256;
    size_t blocks = (n + threads - 1) / threads;
    if (blocks > 132 * 8) blocks = 132 * 8;
    reduce_splits_kernel<<<(unsigned)blocks, threads, 0, stream>>>(partial, out, splits, n,
                                                                   out_f32);
    return cudaGetLastError();
}

template <int M>
cudaError_t launch_wholef(const void* x, const void* codes, const void* scales, void* out,
                          float* partial, int H, int F, int qblock, int splits,
                          int rows_per_split, int out_f32, cudaStream_t stream) {
    const dim3 grid((F + WF_COLS - 1) / WF_COLS, splits);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    qmm_wholef_kernel<M><<<grid, WF_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const int8_t*>(codes),
        static_cast<const float*>(scales), out, splits > 1 ? partial : nullptr,
        H, F, qblock, rows_per_split, out_f32);
    return cudaGetLastError();
}

template <int BM>
cudaError_t launch_wgmma(const void* x, const void* codes, const void* scales, void* out,
                         float* partial, int* counters, int M, int H, int F, int qblock,
                         int splits, int k_tiles_per_split, int out_f32, cudaStream_t stream) {
    using L = QmmPlan<BM>;
    const dim3 grid(F / QMM_BF, (M + BM - 1) / BM, splits);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
    CUtensorMap tm_x, tm_codes, tm_scales;
    using hopper::tensor_map;
    if (!tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, H, QMM_BK, BM,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tensor_map(&tm_codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, H, F, QMM_BF, QMM_BK,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tensor_map(&tm_scales, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scales, F / qblock, H,
                    QMM_BK, 1, CU_TENSOR_MAP_SWIZZLE_NONE))
        return cudaErrorNotSupported;
    auto kernel = qmm_wgmma_kernel<BM>;
    // raise the shared-memory limit once per device, not on every launch (a
    // launch may be captured into a CUDA graph)
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !allowed[dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)L::kBytes);
        if (err != cudaSuccess) return err;
        if (dev < 64) allowed[dev] = true;
    }
    kernel<<<grid, QMM_THREADS, L::kBytes, stream>>>(
        tm_x, tm_codes, tm_scales, out, splits > 1 ? partial : nullptr, counters, M, H, F, qblock,
        k_tiles_per_split, out_f32);
    return cudaGetLastError();
}

bool valid_shape(int M, int H, int F, int qblock, int splits, const void* partial) {
    return M > 0 && H > 0 && F > 0 && H % 8 == 0 && qblock > 0 && qblock % 128 == 0 &&
           F % qblock == 0 && splits > 0 && (splits == 1 || partial != nullptr);
}

// run `body` on `device`, leaving the caller's current device as it was
template <typename Body>
int on_device(int device, Body body) {
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    err = body();
    if (prev != device) {
        const cudaError_t restore = cudaSetDevice(prev);
        if (err == cudaSuccess) err = restore;
    }
    return (int)err;
}

}  // namespace

extern "C" {

// #11.  block_m 16 or 64 (decode width, m <= 64) or 128 (prefill width);
// `splits` slices of H (at most 8) of ceil(ceil(H / 64) / splits) K tiles
// each.  With more than one, `partial` is an f32 scratch [splits, M, F] and
// `counters` an int32 scratch of one zero per output tile (F / 128 *
// ceil(M / block_m)), left at zero.
int qmm_tiled(int device, const void* x, const void* codes, const void* scales, void* out,
              void* partial, void* counters, int M, int H, int F, int qblock, int block_m,
              int splits, int out_f32, void* stream) {
    if (!valid_shape(M, H, F, qblock, splits, partial) || F % QMM_BF != 0 ||
        splits > QMM_MAX_SPLITS || (splits > 1 && counters == nullptr) ||
        (block_m != 16 && block_m != 64 && block_m != 128))
        return (int)cudaErrorInvalidValue;
    const int k_tiles = (H + QMM_BK - 1) / QMM_BK;
    const int per = (k_tiles + splits - 1) / splits;
    if ((k_tiles + per - 1) / per != splits) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* part = static_cast<float*>(partial);
    int* cnt = static_cast<int*>(counters);
    return on_device(device, [&]() {
        switch (block_m) {
            case 16:
                return launch_wgmma<16>(x, codes, scales, out, part, cnt, M, H, F, qblock, splits,
                                        per, out_f32, st);
            case 64:
                return launch_wgmma<64>(x, codes, scales, out, part, cnt, M, H, F, qblock, splits,
                                        per, out_f32, st);
            default:
                return launch_wgmma<128>(x, codes, scales, out, part, cnt, M, H, F, qblock,
                                         splits, per, out_f32, st);
        }
    });
}

// #12, M <= 8.  `splits` slices of H of round_up(ceil(H / splits), 8) rows.
int qmm_wholef(int device, const void* x, const void* codes, const void* scales, void* out,
               void* partial, int M, int H, int F, int qblock, int splits, int out_f32,
               void* stream) {
    if (!valid_shape(M, H, F, qblock, splits, partial) || M > 8)
        return (int)cudaErrorInvalidValue;
    const int rows = ((H + splits - 1) / splits + 7) / 8 * 8;
    if ((H + rows - 1) / rows != splits) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* part = static_cast<float*>(partial);
    return on_device(device, [&]() {
        cudaError_t err;
        switch (M) {
#define QMM_WHOLEF_CASE(m)                                                                \
            case m:                                                                       \
                err = launch_wholef<m>(x, codes, scales, out, part, H, F, qblock, splits, \
                                       rows, out_f32, st);                                \
                break;
            QMM_WHOLEF_CASE(1) QMM_WHOLEF_CASE(2) QMM_WHOLEF_CASE(3) QMM_WHOLEF_CASE(4)
            QMM_WHOLEF_CASE(5) QMM_WHOLEF_CASE(6) QMM_WHOLEF_CASE(7) QMM_WHOLEF_CASE(8)
#undef QMM_WHOLEF_CASE
            default:
                err = cudaErrorInvalidValue;
        }
        if (err == cudaSuccess && splits > 1)
            err = reduce_splits(part, out, splits, (size_t)M * F, out_f32, st);
        return err;
    });
}

const char* qmm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
