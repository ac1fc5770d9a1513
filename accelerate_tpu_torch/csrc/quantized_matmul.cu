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
// #12, qmm_wholef: one launch of blocks of 128 output columns by a slice
// of H, about one and a half waves on the 132 SMs (ops/quantized_matmul.py
// wholef_plan: at most 8 slices, each at least two 64-row K tiles).  A
// producer warp issues the slice's code tiles by TMA (128-byte swizzle, up
// to 16 in flight: the whole slice at the 600m shapes) as the block
// starts; meanwhile the 8 consumer warps stage bf16(x * s) for the slice,
// behind one barrier.  The product runs on the tensor cores (mma.sync
// m16n8k16, out^T = codes^T xs^T): the codes, exact in bf16 and widened by
// byte permutes, are the A operand of 16 columns a warp, read by
// ldmatrix.trans as #11 reads them; bf16(x * s) is B, the <= 8 rows of x
// as n.  The rounding is the TPU kernel's: one bf16 rounding of x * s,
// exact codes, f32 sums.  The blocks of one column tile form a
// thread-block cluster: each keeps its f32 partial tile in shared memory,
// and block 0 adds them in slice order through distributed shared memory
// (no scratch, no counters): on the card the counter scheme #11 uses (a
// fence, an atomic and a reread from L2 by the last block, in series) was
// the largest part of a call at these shapes (PERF.md, section 6).
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

constexpr int WF_BF = 128;                 // output columns per block: one 128-byte code row
constexpr int WF_BK = 64;                  // rows of H per code tile
constexpr int WF_TILE = WF_BK * WF_BF;     // bytes of a code tile, 128-byte swizzle
constexpr int WF_STAGES = 16;              // code tiles in flight, at most
constexpr int WF_MAX_PER = 64;             // most K tiles a slice holds (bounds the staged x * s)
constexpr int WF_MAX_SPLITS = 8;           // slices of H: the blocks of a (portable) cluster
constexpr int WF_THREADS = 288;            // 8 consumer warps (16 columns each) and a producer warp

// bytes of dynamic shared memory: the 1024-byte alignment slack, `stages`
// code tiles, the slice's staged bf16(x * s) (M rows of `per` K tiles and a
// 16-byte pad), the block's f32 partial tile and the stages' mbarriers
__host__ __device__ constexpr size_t wf_smem_bytes(int M, int per, int stages) {
    return 1024 + (size_t)stages * WF_TILE + (size_t)M * (per * WF_BK + 8) * 2 +
           (size_t)M * WF_BF * 4 + 16 * stages;
}

// d[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16_k16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The split's slices of H are blockIdx.y, each `per` K tiles of 64 rows
// (the last may be shorter), and the blocks of one column tile form a
// cluster.  A producer warp copies the slice's code tiles by TMA into a
// ring of `stages` tiles as soon as the block starts; the 8 consumer warps
// meanwhile stage xs[m][r] = bf16(f32(x[m][h0 + r]) * s[n0 / qb][h0 + r])
// for the whole slice (one barrier), then run mma.sync m16n8k16 on each
// arrived tile: A = the codes of the warp's 16 columns (exact in bf16;
// ldmatrix.trans as #11's weight_fragments reads them), B = xs with the M
// <= 8 rows of x as n, two accumulators in turn.  With more than one
// slice, each block leaves its f32 partial tile in its shared memory and
// the cluster's block 0 adds them in slice order through distributed
// shared memory.
template <int M>
__global__ void __launch_bounds__(WF_THREADS)
qmm_wholef_kernel(const __grid_constant__ CUtensorMap tm_codes, const bf16* __restrict__ x,
                  const float* __restrict__ scales, void* __restrict__ out, int H, int F,
                  int qblock, int per, int stages, int out_f32) {
    const int n0 = blockIdx.x * WF_BF;
    const int split = blockIdx.y;
    const int splits = gridDim.y;
    const int k_tiles = (H + WF_BK - 1) / WF_BK;
    const int kt0 = split * per;
    const int nkt = min(per, k_tiles - kt0);
    const int h_begin = kt0 * WF_BK;
    const int rows = nkt * WF_BK;                // staged rows, zeros past H
    const int xs_stride = rows + 8;              // 16 bytes of pad: conflict-free B loads
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

    extern __shared__ unsigned char smem_raw[];
    // the swizzled code tiles need 1024-byte aligned shared addresses
    unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
    bf16* xs = reinterpret_cast<bf16*>(smem + (size_t)stages * WF_TILE);
    float* part = reinterpret_cast<float*>(xs + (size_t)M * (per * WF_BK + 8));   // [M][128]
    const uint32_t sbase = hopper::smem_u32(smem);
    const uint32_t full0 = hopper::smem_u32(part + M * WF_BF);
    const uint32_t empty0 = full0 + 8 * stages;
    if (tid == 0) {
        for (int st = 0; st < stages; ++st) {
            hopper::mbar_init(full0 + 8 * st, 1);
            hopper::mbar_init(empty0 + 8 * st, 8);
        }
        hopper::mbar_init_fence();
    }
    __syncthreads();

    if (warp == 8) {
        // producer: every code tile of the slice, `stages` ahead of the
        // consumers, the first ones before any arithmetic
        if (lane == 0) {
            for (int kt = 0; kt < nkt; ++kt) {
                const int st = kt % stages;
                if (kt >= stages) hopper::mbar_wait(empty0 + 8 * st, ((kt / stages) - 1) & 1);
                const uint32_t full = full0 + 8 * st;
                hopper::mbar_arrive_expect_tx(full, WF_TILE);
                hopper::tma_load_2d(sbase + st * WF_TILE, &tm_codes, full, n0, h_begin + kt * WF_BK);
            }
        }
        __syncwarp();
    } else {
        // xs for the whole slice, 8 values of one row of x a thread at a time
        const int fb = n0 / qblock;
        const int units = M * (rows / 8);
        for (int i = tid; i < units; i += 256) {
            const int m = i / (rows / 8);
            const int r = (i % (rows / 8)) * 8;
            const int h = h_begin + r;
            uint4 packed = make_uint4(0u, 0u, 0u, 0u);
            if (h < H) {      // H % 8 == 0: the 8 values lie wholly inside or outside
                const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * H + h));
                const float* sp = scales + (size_t)fb * H + h;
                const float4 s0 = __ldg(reinterpret_cast<const float4*>(sp));
                const float4 s1 = __ldg(reinterpret_cast<const float4*>(sp + 4));
                const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&xv);
                const float2 x01 = __bfloat1622float2(x2[0]), x23 = __bfloat1622float2(x2[1]);
                const float2 x45 = __bfloat1622float2(x2[2]), x67 = __bfloat1622float2(x2[3]);
                packed.x = hopper::pack_bf16(x01.x * s0.x, x01.y * s0.y);
                packed.y = hopper::pack_bf16(x23.x * s0.z, x23.y * s0.w);
                packed.z = hopper::pack_bf16(x45.x * s1.x, x45.y * s1.y);
                packed.w = hopper::pack_bf16(x67.x * s1.z, x67.y * s1.w);
            }
            *reinterpret_cast<uint4*>(xs + (size_t)m * xs_stride + r) = packed;
        }
        hopper::named_barrier(1, 256);

        // out^T[16 columns x 8] += codes^T[16 x k16] . xs^T[k16 x 8] per
        // step: A row g is column f = n0 + 16 warp + 2g, row g + 8 is f + 1
        // (a thread's two rows are adjacent columns); B column n is row n of x
        const int g = lane >> 2, t4 = lane & 3;
        const bf16* xrow = xs + (size_t)(g < M ? g : 0) * xs_stride + 2 * t4;
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int kt = 0; kt < nkt; ++kt) {
            const int st = kt % stages;
            hopper::mbar_wait(full0 + 8 * st, (kt / stages) & 1);
            const unsigned char* cs = smem + st * WF_TILE;
            uint32_t w[2][4];
#pragma unroll
            for (int q = 0; q < WF_BK / 32; ++q) {
                const int row = 32 * q + lane;   // lanes 8i..8i+7 give matrix i's rows
                asm volatile(
                    "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                    : "=r"(w[q][0]), "=r"(w[q][1]), "=r"(w[q][2]), "=r"(w[q][3])
                    : "r"(hopper::smem_u32(cs + row * 128 + ((warp ^ (row & 7)) << 4))));
            }
            // this tile's codes are in registers: its stage is free
            __syncwarp();
            if (lane == 0) hopper::mbar_arrive(empty0 + 8 * st);
#pragma unroll
            for (int q = 0; q < WF_BK / 32; ++q) {
#pragma unroll
                for (int step = 0; step < 2; ++step) {
                    const int h = kt * WF_BK + 32 * q + 16 * step;
                    const uint32_t lo = w[q][2 * step] ^ 0x80808080u;      // rows h + 2t, + 1
                    const uint32_t hi = w[q][2 * step + 1] ^ 0x80808080u;  // rows h + 2t + 8, + 9
                    const uint32_t b0 = g < M ? *reinterpret_cast<const uint32_t*>(xrow + h) : 0u;
                    const uint32_t b1 =
                        g < M ? *reinterpret_cast<const uint32_t*>(xrow + h + 8) : 0u;
                    mma_bf16_k16(d[step],
                                 hopper::pack_bf16(code_at(lo, 0), code_at(lo, 2)),   // f
                                 hopper::pack_bf16(code_at(lo, 1), code_at(lo, 3)),   // f + 1
                                 hopper::pack_bf16(code_at(hi, 0), code_at(hi, 2)),
                                 hopper::pack_bf16(code_at(hi, 1), code_at(hi, 3)), b0, b1);
                }
            }
        }

        // d[.][0], d[.][1]: rows 2t, 2t + 1 of x at column f; d[.][2],
        // d[.][3]: the same at f + 1
        const int f = 16 * warp + 2 * g;
        const int m0 = 2 * t4, m1 = 2 * t4 + 1;
        const float v00 = d[0][0] + d[1][0], v10 = d[0][1] + d[1][1];
        const float v01 = d[0][2] + d[1][2], v11 = d[0][3] + d[1][3];
        if (splits == 1) {
            if (m0 < M) store2(out, (size_t)m0 * F + n0 + f, v00, v01, out_f32);
            if (m1 < M) store2(out, (size_t)m1 * F + n0 + f, v10, v11, out_f32);
        } else {
            if (m0 < M) *reinterpret_cast<float2*>(part + m0 * WF_BF + f) = make_float2(v00, v01);
            if (m1 < M) *reinterpret_cast<float2*>(part + m1 * WF_BF + f) = make_float2(v10, v11);
        }
    }
    if (splits == 1) return;

    // H split: the cluster's block 0 adds the slices' partial tiles in slice
    // order (rank = slice: the cluster spans gridDim.y); the others keep
    // theirs until it has read them
    hopper::cluster_sync();
    if (hopper::cluster_ctarank() == 0) {
        const uint32_t part0 = hopper::smem_u32(part);
        for (int p = tid; p < M * (WF_BF / 4); p += WF_THREADS) {
            const int m = p / (WF_BF / 4), c = (p % (WF_BF / 4)) * 4;
            const uint32_t addr = part0 + (uint32_t)(m * WF_BF + c) * 4;
            float4 v[WF_MAX_SPLITS];
#pragma unroll
            for (int sp = 0; sp < WF_MAX_SPLITS; ++sp)
                if (sp < splits) v[sp] = hopper::ld_cluster_f4(addr, sp);
            float4 sum = v[0];
#pragma unroll
            for (int sp = 1; sp < WF_MAX_SPLITS; ++sp) {
                if (sp < splits) {
                    sum.x += v[sp].x;
                    sum.y += v[sp].y;
                    sum.z += v[sp].z;
                    sum.w += v[sp].w;
                }
            }
            store4(out, (size_t)m * F + n0 + c, sum, out_f32);
        }
    }
    hopper::cluster_sync();
}

template <int M>
cudaError_t launch_wholef(const void* x, const void* codes, const void* scales, void* out, int H,
                          int F, int qblock, int splits, int per, int out_f32,
                          cudaStream_t stream) {
    CUtensorMap tm_codes;
    if (!hopper::tensor_map(&tm_codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, H, F, WF_BF, WF_BK,
                            CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorNotSupported;
    const int stages = per < WF_STAGES ? per : WF_STAGES;
    auto kernel = qmm_wholef_kernel<M>;
    // raise the shared-memory limit to the largest plan once per device,
    // not on every launch (a launch may be captured into a CUDA graph)
    static bool allowed[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !allowed[dev]) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)wf_smem_bytes(M, WF_MAX_PER, WF_STAGES));
        if (err != cudaSuccess) return err;
        if (dev < 64) allowed[dev] = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(F / WF_BF, splits);
    cfg.blockDim = dim3(WF_THREADS);
    cfg.dynamicSmemBytes = wf_smem_bytes(M, per, stages);
    cfg.stream = stream;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = splits;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, tm_codes, static_cast<const bf16*>(x),
                             static_cast<const float*>(scales), out, H, F, qblock, per, stages,
                             out_f32);
    if (err != cudaSuccess) return err;
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

bool valid_shape(int M, int H, int F, int qblock, int splits) {
    return M > 0 && H > 0 && F > 0 && H % 8 == 0 && qblock > 0 && qblock % 128 == 0 &&
           F % qblock == 0 && splits > 0;
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
    if (!valid_shape(M, H, F, qblock, splits) || F % QMM_BF != 0 || splits > QMM_MAX_SPLITS ||
        (splits > 1 && (partial == nullptr || counters == nullptr)) ||
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

// #12, M <= 8.  `splits` (at most 8) slices of H of ceil(ceil(H / 64) /
// splits) K tiles each (at most 64), added in one launch.
int qmm_wholef(int device, const void* x, const void* codes, const void* scales, void* out,
               int M, int H, int F, int qblock, int splits, int out_f32, void* stream) {
    if (!valid_shape(M, H, F, qblock, splits) || M > 8 || splits > WF_MAX_SPLITS)
        return (int)cudaErrorInvalidValue;
    const int k_tiles = (H + WF_BK - 1) / WF_BK;
    const int per = (k_tiles + splits - 1) / splits;
    if ((k_tiles + per - 1) / per != splits || per > WF_MAX_PER) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return on_device(device, [&]() {
        switch (M) {
#define QMM_WHOLEF_CASE(m)                                                                   \
            case m:                                                                          \
                return launch_wholef<m>(x, codes, scales, out, H, F, qblock, splits, per,   \
                                        out_f32, st);
            QMM_WHOLEF_CASE(1) QMM_WHOLEF_CASE(2) QMM_WHOLEF_CASE(3) QMM_WHOLEF_CASE(4)
            QMM_WHOLEF_CASE(5) QMM_WHOLEF_CASE(6) QMM_WHOLEF_CASE(7) QMM_WHOLEF_CASE(8)
#undef QMM_WHOLEF_CASE
            default:
                return cudaErrorInvalidValue;
        }
    });
}

const char* qmm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
