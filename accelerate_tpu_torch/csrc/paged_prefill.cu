// Paged multi-token attention on the tensor cores, hand-written for Hopper
// (sm_90a): one kernel template over the page element.
//
//   paged_multitoken_attention_bf16  replaces the Pallas TPU kernel
//       accelerate_tpu/ops/flash_attention.py  _paged_multitoken_kernel
//       (launched by paged_multitoken_attention over bf16 pages): kernel #6;
//   paged_multitoken_attention_{int8,fp8}  replace _paged_multitoken_kernel_quant
//       (the same over int8 / e4m3 pages): kernel #7.  Pages are codes with
//       one f32 amax per (kv head, page) in k_scales / v_scales [Hkv, P]; a
//       code stands for f32(code) * (amax / QMAX), QMAX 127 (int8) or 448
//       (e4m3).
// Both run once per layer on every prefill chunk of a serve: a window of T
// contiguous query tokens per slot against the slot's paged K/V.
//
// Semantics (those of _paged_multitoken_body):
//   * q / out [S, T, H, D] bf16, pages [Hkv, P, page, D], block_tables
//     [S, n], positions [S, T] (column 0 read): query row r of a slot is
//     token r / group of q head h * group + r % group (token-major rows),
//     and sees kv index i iff i <= pos0 + r / group;
//   * masked scores take the finite value -0.7 * FLT_MAX; the online softmax
//     starts at m = -inf, l = 0, acc = 0; the result is acc / l, or acc
//     where l == 0;
//   * pages past the page of the row tile's last row are skipped (not
//     visited): a window wholly before position 0 gives zeros.
//
// Design.  One block of one warpgroup (128 threads) per (64 query rows,
// kv head, slot); row tiles that walk the most kv tiles are scheduled
// first.  The block walks kv tiles of 64 tokens whatever the page size:
// each token is found through its own block-table entry (page i / page,
// row i % page), so a tile may hold several pages (pages of 1 to 32), part
// of one (pages of 100) or exactly one (pages of 64); a page of 128 spans
// two tiles.
//   * The block table row (and, for codes, each page's two amaxes) is
//     staged in shared memory once, so a tile's addresses never wait on a
//     global load.
//   * bf16 pages: each token row goes by cp.async, 16 bytes a copy, straight
//     into its place in the 128-byte-swizzled K and V tiles, three stages
//     deep (tiles j + 1 and j + 2 in flight under tile j's math); there is
//     no staging area and no widening pass.
//   * Codes: they arrive by cp.async at one byte per element, double-
//     buffered.  Every int8 code (|c| <= 127) and every e4m3 value is exact
//     in bf16, and the scale is constant over a page, so codes widen once
//     per element to bf16 tiles with no multiply.
//   * S = Q K^T is wgmma m64n64k16 (Q from registers, K the K-major B
//     operand), D in k16 steps; sm_scale * log2(e) (times the column's K
//     scale for codes) multiplies S's columns after the product.  The
//     online softmax stays in registers (row max and row sum over the four
//     lanes of a quad).  p (times the column's V scale for codes) is rounded
//     once to bf16 and is the register A operand of P V, V the MN-major B
//     operand (the transpose bit), in 64- and 32-wide wgmmas.
//   * The kernel's departures from exact f32 arithmetic besides its f32
//     sums: the bf16 rounding of p (p * v_scale for codes); the exponential,
//     ex2.approx.ftz.f32 (about 2 ulp, subnormal inputs and results flushed
//     to zero), on scores kept in base-2 units; for codes, the reassociated
//     K scale ((q . code) * scale in place of q . (code * scale)).
//
// What bounds it on an H100: a 512-token chunk of the 600m model (16 q /
// 8 kv heads, D 96) does 4 * 96 flops per (row, visible key) pair, about
// 0.8 GFLOP over 1.6 MB of bf16 pages (0.8 MB of codes): below a
// microsecond at either roof.  The kernel is bound by its latency chain
// per kv tile (copy wait, for codes the widening, product, softmax,
// product), which the copies in flight shorten.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (accelerate_tpu_torch/ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr float kMaskValue = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}
constexpr int kThreads = 128;   // one warpgroup
constexpr int kRows = 64;       // query rows per block
constexpr int kCols = 64;       // kv tokens per tile

// the page element: bf16 (copied as it is) or a one-byte code widened to bf16
struct Bf16Pages {
    static constexpr bool kQuant = false;
    typedef bf16 Elem;
};

struct Int8Codes {
    static constexpr bool kQuant = true;
    typedef uint8_t Elem;
    static constexpr float kQmax = 127.f;
    // four codes -> four bf16, exactly: each code through the f32 bit
    // pattern 2^23 + (code + 128) (a byte permute, no int-to-float convert)
    __device__ static uint2 widen4(uint32_t word) {
        const uint32_t u = word ^ 0x80808080u;
        float f[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)
            f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) - 8388736.f;
        return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
    }
    __device__ static uint4 widen8(uint2 raw) {
        const uint2 lo = widen4(raw.x), hi = widen4(raw.y);
        return make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
};

struct Fp8Codes {
    static constexpr bool kQuant = true;
    typedef uint8_t Elem;
    static constexpr float kQmax = 448.f;
    __device__ static uint32_t widen2(uint16_t two) {   // e4m3 -> half -> bf16, exact
        const __half2 h = __half2(__nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3));
        const float2 f = __half22float2(h);
        return pack_bf16(f.x, f.y);
    }
    __device__ static uint4 widen8(uint2 raw) {
        uint4 o;
        o.x = widen2((uint16_t)(raw.x & 0xFFFF));
        o.y = widen2((uint16_t)(raw.x >> 16));
        o.z = widen2((uint16_t)(raw.y & 0xFFFF));
        o.w = widen2((uint16_t)(raw.y >> 16));
        return o;
    }
};

// shared-memory plan of one block at head dim D and n block-table entries:
// bf16 pages fill kStages stages of (K, V) bf16 tiles in place; codes fill
// two stages of (K, V) codes, widened into one (K, V) pair of bf16 tiles
template <typename C, int D>
struct Plan {
    static constexpr int kStages = C::kQuant ? 1 : 3;       // (K, V) bf16 tile pairs
    static constexpr int kChunks = (D + 63) / 64;          // 64-column chunks of a bf16 tile
    static constexpr int kTileBytes = kChunks * kCols * 128;
    static constexpr int kCodeBytes = C::kQuant ? kCols * D : 0;   // one tile of codes
    static constexpr int kK = 0;                            // stage s: K at kK + 2 s kTileBytes, V after
    static constexpr int kStage = kK + kStages * 2 * kTileBytes;    // 2 stages x (K codes, V codes)
    static constexpr int kColScale = kStage + 4 * kCodeBytes;       // [2][kCols] f32 (codes)
    static constexpr int kTable = kColScale + (C::kQuant ? 2 * kCols * 4 : 0);
    // [n] int32 page ids, then for codes [n] k amax, [n] v amax
    static size_t bytes(int n) {
        return (size_t)kTable + (C::kQuant ? 12 : 4) * (size_t)n + 1024;
    }
};

template <typename C, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const bf16* __restrict__ q, const typename C::Elem* __restrict__ k_pages,
                     const typename C::Elem* __restrict__ v_pages,
                     const float* __restrict__ k_scales, const float* __restrict__ v_scales,
                     const int* __restrict__ block_tables, const int* __restrict__ positions,
                     bf16* __restrict__ out, int T, int H, int Hkv, int P, int page, int n,
                     int pos_stride, float sm_scale) {
    using L = Plan<C, D>;
    using E = typename C::Elem;
    constexpr int KSTEPS = D / 16;
    constexpr int PIECE = 16 / (int)sizeof(E);   // elements per 16-byte copy
    constexpr int CH16 = D / PIECE;              // 16-byte copies of a token row
    constexpr int CH8 = D / 8;                   // 8-element bf16 groups of a token row

    const int row_tiles = gridDim.x;
    const int z = row_tiles - 1 - (int)blockIdx.x;   // heaviest row tiles first
    const int h = blockIdx.y;
    const int s = blockIdx.z;
    const int group = H / Hkv;
    const int r0 = z * kRows;
    const int nrows = min(kRows, T * group - r0);
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;

    extern __shared__ unsigned char smem_raw[];
    // the swizzled tiles need 1024-byte aligned shared addresses
    unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const uint32_t sbase = smem_u32(smem);
    float* col_k = reinterpret_cast<float*>(smem + L::kColScale);   // codes only
    float* col_v = col_k + kCols;
    int* table = reinterpret_cast<int*>(smem + L::kTable);
    float* amax_k = reinterpret_cast<float*>(table + n);              // codes only
    float* amax_v = amax_k + n;

    const int pos0 = positions[(size_t)s * pos_stride];
    // scores are kept in base-2 units: sm_scale * log2(e) rides on the K scale
    const float sm_scale_log2 = sm_scale * kLog2e;
    const int last_pos = pos0 + (r0 + nrows - 1) / group;
    const int last_page = last_pos < 0 ? -1 : min(last_pos / page, n - 1);
    const int kv_end = (last_page + 1) * page;          // kv indices visited
    const int n_tiles = (kv_end + kCols - 1) / kCols;
    const int npg = last_page + 1;

    // this thread's two query rows (16 * warp + g, + 8) as register A
    // fragments, zero past the window
    uint32_t qf[KSTEPS][4];
    int row_limit[2];
    size_t row_out[2];
    bool row_live[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + g + 8 * hh;
        const int gr = r0 + r;
        row_live[hh] = r < nrows;
        const int tok = gr / group;
        row_limit[hh] = pos0 + tok;
        row_out[hh] = (((size_t)s * T + tok) * H + (size_t)h * group + gr % group) * D;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int hh = e & 1;
            const int col = 16 * kk + 2 * t4 + 8 * (e >> 1);
            qf[kk][e] = row_live[hh]
                ? *reinterpret_cast<const uint32_t*>(q + row_out[hh] + col) : 0u;
        }
    }

    // the visited block-table entries, then (codes) each page's amaxes by
    // cp.async, in the first copy group
    for (int i = tid; i < npg; i += kThreads) table[i] = block_tables[(size_t)s * n + i];
    __syncthreads();
    if constexpr (C::kQuant) {
        for (int i = tid; i < npg; i += kThreads) {
            const size_t sidx = (size_t)h * P + table[i];
            cp_async4(smem_u32(amax_k + i), k_scales + sidx, true);
            cp_async4(smem_u32(amax_v + i), v_scales + sidx, true);
        }
    }

    // copies of kv tile j's token rows, zero past the visited pages: codes
    // into code stage st, row-major; bf16 rows into their swizzled places
    // in stage st's K and V tiles
    auto issue = [&](int j, int st) {
        const uint32_t kdst = C::kQuant ? sbase + L::kStage + st * 2 * L::kCodeBytes
                                        : sbase + L::kK + st * 2 * L::kTileBytes;
        const uint32_t vdst = kdst + (C::kQuant ? L::kCodeBytes : L::kTileBytes);
        for (int c = tid; c < kCols * CH16; c += kThreads) {
            const int tok = c / CH16;
            const int part = c % CH16;
            const int i = j * kCols + tok;
            const bool ok = i < kv_end;
            size_t src = 0;
            if (ok) {
                const int pid = table[i / page];
                src = (((size_t)h * P + pid) * page + i % page) * D + part * PIECE;
            }
            const uint32_t off = C::kQuant ? c * 16 : sw128_offset(tok, part * PIECE, kCols);
            cp_async16(kdst + off, k_pages + src, ok);
            cp_async16(vdst + off, v_pages + src, ok);
        }
    };

    float acc[L::kChunks][32];
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    if constexpr (C::kQuant) {
        if (n_tiles > 0) issue(0, 0);
        cp_async_commit();
    } else {
#pragma unroll
        for (int st = 0; st < L::kStages - 1; ++st) {
            if (st < n_tiles) issue(st, st);
            cp_async_commit();
        }
    }

    for (int j = 0; j < n_tiles; ++j) {
        int ts = 0;   // the (K, V) bf16 tile pair tile j is read from
        if constexpr (C::kQuant) {
            const int st = j & 1;
            if (j + 1 < n_tiles) issue(j + 1, st ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
            __syncthreads();

            // widen tile j's codes into the bf16 K and V tiles; each tile
            // column's scales
            const unsigned char* kc = smem + L::kStage + st * 2 * L::kCodeBytes;
            const unsigned char* vc = kc + L::kCodeBytes;
            for (int c = tid; c < kCols * CH8; c += kThreads) {
                const int tok = c / CH8;
                const int col = (c % CH8) * 8;
                const uint32_t off = sw128_offset(tok, col, kCols);
                *reinterpret_cast<uint4*>(smem + L::kK + off) =
                    C::widen8(*reinterpret_cast<const uint2*>(kc + tok * D + col));
                *reinterpret_cast<uint4*>(smem + L::kK + L::kTileBytes + off) =
                    C::widen8(*reinterpret_cast<const uint2*>(vc + tok * D + col));
            }
            if (tid < kCols) {
                const int i = j * kCols + tid;
                const int pi = min(i, kv_end - 1) / page;
                col_k[tid] = __fdiv_rn(amax_k[pi], C::kQmax) * sm_scale_log2;
                col_v[tid] = __fdiv_rn(amax_v[pi], C::kQmax);
            }
            fence_async_shared();
            __syncthreads();
        } else {
            // tile j's copies (this thread's) have landed; the barrier makes
            // every thread's visible, and frees the stage tile j - 1 was
            // read from for tile j + kStages - 1
            ts = j % L::kStages;
            cp_async_wait<L::kStages - 2>();
            fence_async_shared();
            __syncthreads();
            if (j + L::kStages - 1 < n_tiles)
                issue(j + L::kStages - 1, (j + L::kStages - 1) % L::kStages);
            cp_async_commit();
        }
        const uint32_t ktile = sbase + L::kK + ts * 2 * L::kTileBytes;
        const uint32_t vtile = ktile + L::kTileBytes;

        // S = Q K^T over the D / 16 k-steps
        float sc[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
            const uint32_t addr = ktile + (kk >> 2) * kCols * 128 + (kk & 3) * 32;
            wgmma_m64n64k16_rs<0>(sc, qf[kk], sw128_desc(addr));
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 32; ++e) fence_operand(sc[e]);

        // scale, mask and the online softmax, in registers; a tile every
        // column of which this thread's rows see and visit skips the mask
        const int kv0 = j * kCols;
        const bool open = kv0 + kCols <= kv_end && kv0 + kCols - 1 <= min(row_limit[0], row_limit[1]);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
            float2 ck = make_float2(sm_scale_log2, sm_scale_log2);
            if constexpr (C::kQuant) ck = *reinterpret_cast<const float2*>(col_k + 8 * jb + 2 * t4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hh = e >> 1;
                float x = sc[4 * jb + e] * ((e & 1) ? ck.y : ck.x);
                if (!open) {
                    const int i = kv0 + 8 * jb + 2 * t4 + (e & 1);
                    x = i >= kv_end ? -INFINITY : (i > row_limit[hh] ? kMaskValue : x);
                }
                sc[4 * jb + e] = x;
                mx[hh] = fmaxf(mx[hh], x);
            }
        }
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
            mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
            const float m_new = fmaxf(m_run[hh], mx[hh]);   // finite: column 0 is visited
            alpha[hh] = exp2_approx(m_run[hh] - m_new);
            m_run[hh] = m_new;
        }
        float rs[2] = {0.f, 0.f};
        uint32_t pf[4][4];
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
            float pv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int hh = e >> 1;
                const float p = exp2_approx(sc[4 * jb + e] - m_run[hh]);
                rs[hh] += p;
                pv[e] = p;
            }
            if constexpr (C::kQuant) {
                const float2 cv = *reinterpret_cast<const float2*>(col_v + 8 * jb + 2 * t4);
                pv[0] *= cv.x;
                pv[1] *= cv.y;
                pv[2] *= cv.x;
                pv[3] *= cv.y;
            }
            // k-step jb / 2 of P V: a0 / a1 from the even 8-column block,
            // a2 / a3 from the odd one
            pf[jb >> 1][(jb & 1) * 2 + 0] = pack_bf16(pv[0], pv[1]);
            pf[jb >> 1][(jb & 1) * 2 + 1] = pack_bf16(pv[2], pv[3]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + rs[hh];
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e >> 1) & 1];

        // acc += P V, 64 head-dim columns per wgmma (32 for D 96's tail)
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int c = 0; c < L::kChunks; ++c) {
                const uint32_t addr = vtile + c * kCols * 128 + kk * 2048;
                if (D - 64 * c >= 64) {
                    wgmma_m64n64k16_rs<1>(acc[c], pf[kk], sw128_desc(addr));
                } else {
                    wgmma_m64n32k16_rs<1>(acc[c], pf[kk], sw128_desc(addr));
                }
            }
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) fence_operand(pf[kk][e]);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
            for (int e = 0; e < 32; ++e) fence_operand(acc[c][e]);
    }
    cp_async_wait<0>();

    // the row sums over the quad, then acc / l (or acc where l == 0)
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        float l = l_run[hh];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[hh] = l == 0.f ? 1.f : l;
    }
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c) {
        constexpr int full = 64;
        const int width = D - 64 * c >= full ? full : D - 64 * c;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
            if (8 * jb >= width) continue;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                if (!row_live[hh]) continue;
                const int col = 64 * c + 8 * jb + 2 * t4;
                *reinterpret_cast<__nv_bfloat162*>(out + row_out[hh] + col) =
                    __floats2bfloat162_rn(acc[c][4 * jb + 2 * hh] / inv[hh],
                                          acc[c][4 * jb + 2 * hh + 1] / inv[hh]);
            }
        }
    }
}

template <typename C, int D>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales, const void* block_tables,
                   const void* positions, void* out, int S, int T, int H, int Hkv, int P,
                   int page, int n, float sm_scale, cudaStream_t stream) {
    using E = typename C::Elem;
    const int rows = T * (H / Hkv);
    const dim3 grid((rows + kRows - 1) / kRows, Hkv, S);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
    const size_t smem = Plan<C, D>::bytes(n);
    auto kernel = paged_prefill_kernel<C, D>;
    // raise the shared-memory limit once per device and size, not on every
    // launch (a launch may be captured into a CUDA graph)
    static size_t smem_allowed[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (smem > 48 * 1024 && (dev >= 64 || smem > smem_allowed[dev])) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        if (dev < 64) smem_allowed[dev] = smem;
    }
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const E*>(k_pages),
        static_cast<const E*>(v_pages), static_cast<const float*>(k_scales),
        static_cast<const float*>(v_scales), static_cast<const int*>(block_tables),
        static_cast<const int*>(positions), static_cast<bf16*>(out), T, H, Hkv, P, page, n,
        T, sm_scale);
    return cudaGetLastError();
}

template <typename C>
int dispatch(int device, const void* q, const void* k_pages, const void* v_pages,
             const void* k_scales, const void* v_scales, const void* block_tables,
             const void* positions, void* out, int S, int T, int H, int Hkv, int D, int P,
             int page, int n, float sm_scale, void* stream) {
    if (S <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0 || n <= 0 ||
        (C::kQuant && (k_scales == nullptr || v_scales == nullptr)))
        return (int)cudaErrorInvalidValue;
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 64:
            err = launch<C, 64>(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                positions, out, S, T, H, Hkv, P, page, n, sm_scale, st);
            break;
        case 96:
            err = launch<C, 96>(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                positions, out, S, T, H, Hkv, P, page, n, sm_scale, st);
            break;
        case 128:
            err = launch<C, 128>(q, k_pages, v_pages, k_scales, v_scales, block_tables,
                                 positions, out, S, T, H, Hkv, P, page, n, sm_scale, st);
            break;
        default:
            err = cudaErrorInvalidValue;
    }
    if (prev != device) {
        const cudaError_t restore = cudaSetDevice(prev);
        if (err == cudaSuccess) err = restore;
    }
    return (int)err;
}

}  // namespace

extern "C" {

// #6: q / out [S, T, H, D] bf16, k_pages / v_pages [Hkv, P, page, D] bf16,
// block_tables [S, n] and positions [S, T] int32 (column 0 read).
int paged_multitoken_attention_bf16(int device, const void* q, const void* k_pages,
                                    const void* v_pages, const void* block_tables,
                                    const void* positions, void* out, int S, int T, int H,
                                    int Hkv, int D, int P, int page, int n, float sm_scale,
                                    void* stream) {
    return dispatch<Bf16Pages>(device, q, k_pages, v_pages, nullptr, nullptr, block_tables,
                               positions, out, S, T, H, Hkv, D, P, page, n, sm_scale, stream);
}

// #7: as above with k_pages / v_pages int8 or e4m3 codes and k_scales /
// v_scales [Hkv, P] f32.
int paged_multitoken_attention_int8(int device, const void* q, const void* k_pages,
                                    const void* v_pages, const void* k_scales,
                                    const void* v_scales, const void* block_tables,
                                    const void* positions, void* out, int S, int T, int H,
                                    int Hkv, int D, int P, int page, int n, float sm_scale,
                                    void* stream) {
    return dispatch<Int8Codes>(device, q, k_pages, v_pages, k_scales, v_scales, block_tables,
                               positions, out, S, T, H, Hkv, D, P, page, n, sm_scale, stream);
}

int paged_multitoken_attention_fp8(int device, const void* q, const void* k_pages,
                                   const void* v_pages, const void* k_scales,
                                   const void* v_scales, const void* block_tables,
                                   const void* positions, void* out, int S, int T, int H,
                                   int Hkv, int D, int P, int page, int n, float sm_scale,
                                   void* stream) {
    return dispatch<Fp8Codes>(device, q, k_pages, v_pages, k_scales, v_scales, block_tables,
                              positions, out, S, T, H, Hkv, D, P, page, n, sm_scale, stream);
}

const char* paged_prefill_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
