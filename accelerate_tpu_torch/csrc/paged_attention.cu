// Fused LoRA query + paged decode attention, hand-written for Hopper
// (sm_90a).
//
// Its entry points share one kernel template, templated on the page
// element type:
//
//   fused_bgmv_paged_decode_bf16     replaces the Pallas TPU kernel
//       accelerate_tpu/ops/flash_attention.py  _fused_bgmv_decode_kernel
//       (launched by fused_bgmv_paged_decode), and
//   fused_bgmv_paged_decode_{int8,fp8}  replace _fused_bgmv_decode_kernel_quant:
//       decode with a per-slot LoRA query delta.  A prologue computes, per
//       (slot, kv head) block, h = x[s] . A[id] in f32 (lora_h: each thread
//       a strided set of A's rows, eight rank columns per 16-byte load, the
//       partials reduced by warp shuffles and across warps in a fixed order), then
//       the group's [group, D] delta from B[id]'s columns of this kv head's
//       q heads, ropes it split-half with the f32 tables at
//       min(max(pos, 0), max_len - 1), and writes f32(q_base) + gate * delta,
//       gate = (id != 0) as a multiply, into an f32 query tile; the page loop
//       then runs on that f32 tile (the TPU kernel's f32 q_scratch: q is
//       never rounded to bf16).  Quantized pages are int8 or e4m3 codes with
//       one f32 amax per (kv head, page) in k_scales / v_scales [Hkv, P],
//       read at one byte per element and widened in the tile to f32(code) *
//       (amax / QMAX) (QMAX 127 / 448), the TPU kernels' _dequant_tile; the
//       scale is looked up through the same block-table entry as the page.
//
// The template is the first design of the plain decode kernels #4 / #5
// (one block per (slot, kv head), pages walked in order), which have moved
// to paged_decode.cu's split page loop.
//
// Semantics (kept from the Pallas bodies):
//   * q [S, T, H, D], pages [Hkv, P, page, D], block_tables [S, n], all
//     row-major; q head h reads kv head h / group (group = H / Hkv);
//   * query row r of a slot is token r / group (token-major rows) and
//     sees kv index i iff i <= pos0 + r / group, pos0 the slot's first
//     position;
//   * q, k and v are widened to f32 in the tile, scores are
//     (q . k) * sm_scale, masked scores take the finite value
//     -0.7 * FLT_MAX, the online softmax starts at m = -inf, l = 0,
//     acc = 0, p . v is taken in f32 with p never rounded to bf16, and
//     the result is acc / l, or acc where l == 0.
//
// Grid: one block per (slot, kv head, row tile).  The TPU grid walked the
// pages serially and carried m, l and acc in VMEM scratch; here the block
// loops over its pages itself, reading each physical page id from the
// block table, and stops at the last page its own last row can see
// (min(last_row_pos / page, n - 1)).  A decode block holds one slot's GQA
// group of query rows (up to 8; larger groups take several row tiles).
//
// What bounds it on an H100: decode reads every live K/V page once for 16
// or so query rows per kv head: it is bound by HBM bytes (the live pages
// over 3.35 TB/s).  Quantized pages halve the bytes: codes travel to shared
// memory at one byte per element and are widened only where the scores
// and p . v read them.  This design is plain CUDA cores, one page in
// flight per block and a barrier between the load and the math; the split
// page loop with bulk copies in flight (paged_decode.cu) has not yet been
// carried over to the fused kernels.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (accelerate_tpu_torch/ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lora_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_fp8_e4m3 fp8;

// DEFAULT_MASK_VALUE of the JAX package: finite, so exp(mask - m) is 0 and
// never NaN.
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// The page element: bf16 (plain pages) or a one-byte code with its QMAX
template <typename E> struct PageElem;
template <> struct PageElem<bf16> {
    static constexpr bool kQuant = false;
    static constexpr float kQmax = 1.f;
};
template <> struct PageElem<int8_t> {
    static constexpr bool kQuant = true;
    static constexpr float kQmax = 127.f;
    __device__ static float widen(uint8_t b) { return (float)(int8_t)b; }
};
template <> struct PageElem<fp8> {
    static constexpr bool kQuant = true;
    static constexpr float kQmax = 448.f;
    __device__ static float widen(uint8_t b) {   // e4m3 -> half is exact
        return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
    }
};

// The LoRA operands of the fused decode entry points: x [S, d_in], a [N, d_in, r], b [N, r, H * D] bf16, ids [S] int32, cos /
// sin [max_len, D / 2] f32.
struct LoraArgs {
    const bf16* x = nullptr;
    const bf16* a = nullptr;
    const bf16* b = nullptr;
    const int* ids = nullptr;
    const float* cos = nullptr;
    const float* sin = nullptr;
    int d_in = 0, r = 0, n_adapters = 0, max_len = 0;
};

constexpr int kMaxLoraRank = 64;

// E: page element; D: head dim; ROW_TILE: query rows per block; RG: row
// groups, so a block has D * RG threads and thread (d, rg) owns output
// column d of rows rg * ROW_TILE / RG .. (rg + 1) * ROW_TILE / RG - 1.  The
// query tile is f32, and a LoRA prologue fills it.
template <typename E, int D, int ROW_TILE, int RG>
struct Tile {
    static constexpr int kThreads = D * RG;
    static constexpr int kRowsPerThread = ROW_TILE / RG;
    static constexpr int kChunks = D / 8;        // 8-element chunks of a q row
    static constexpr int kQStride = D + 4;       // padded f32 q row: an odd number
                                                 // of 16-byte chunks, so the 16-byte
                                                 // reads of 8 lanes hit 32 banks
    static constexpr int kPerLoad = 16 / (int)sizeof(E);   // page elements per 16 bytes
    static constexpr int kStride = D + kPerLoad; // padded K row, likewise
    static constexpr int kPStride = ROW_TILE + 4;  // p stored [token][row]
    static_assert(D % 16 == 0, "head dim must be a multiple of 16");
    static_assert(kThreads % 32 == 0, "block must be whole warps");
    static_assert(kRowsPerThread % 4 == 0, "rows per thread read as float4");
    static_assert(kThreads >= kMaxLoraRank, "one thread per rank column");

    static size_t smem_bytes(int page) {
        return sizeof(float) * (size_t)ROW_TILE * kQStride          // Q
             + sizeof(E) * (size_t)page * (kStride + D)             // K, V
             + sizeof(float) * (size_t)page * kPStride              // scores / p
             + sizeof(float) * 3 * ROW_TILE                         // m, l, alpha
             + sizeof(float) * (kThreads / 32 + 1) * kMaxLoraRank;  // LoRA h
    }
};

// q . k over 8 elements of one row with the f32 q tile: two float4 of q
// against 8 bf16 keys
__device__ __forceinline__ float dot8_f32(const float4 a0, const float4 a1, const uint4 b) {
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
    const float2 f0 = __bfloat1622float2(b2[0]), f1 = __bfloat1622float2(b2[1]);
    const float2 f2 = __bfloat1622float2(b2[2]), f3 = __bfloat1622float2(b2[3]);
    float s = 0.f;
    s = fmaf(a0.x, f0.x, s);
    s = fmaf(a0.y, f0.y, s);
    s = fmaf(a0.z, f1.x, s);
    s = fmaf(a0.w, f1.y, s);
    s = fmaf(a1.x, f2.x, s);
    s = fmaf(a1.y, f2.y, s);
    s = fmaf(a1.z, f3.x, s);
    s = fmaf(a1.w, f3.y, s);
    return s;
}

// the same against 8 one-byte codes widened to f32(code) * scale
template <typename E>
__device__ __forceinline__ float dot8_f32_codes(const float4 a0, const float4 a1,
                                                const uint2 codes, float scale) {
    const uint8_t* c = reinterpret_cast<const uint8_t*>(&codes);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(a[i], PageElem<E>::widen(c[i]) * scale, s);
    return s;
}

// The fused kernels' prologue (T = 1): the block's f32 query rows,
// f32(q_base) + gate * rope(delta), delta = (x[s] . A[id]) . B[id] over the
// columns of this kv head's q heads.  `red` holds THREADS / 32 *
// kMaxLoraRank floats, `hl` kMaxLoraRank.  Every thread of the block calls
// it.
template <int D, int ROW_TILE, int THREADS>
__device__ __forceinline__ void lora_query_tile(const LoraArgs& L, const bf16* __restrict__ q,
                                                float* Qs, int QS, float* red, float* hl,
                                                int s, int h, int H, int group, int r0,
                                                int nrows, int pos0, int tid) {
    const int id = L.ids[s];
    // the same for the whole block: id 0 (the null slot, all zeros) skips h
    // and the B walk, its delta is 0 and q is f32(q_base) exactly
    const bool valid = id > 0 && id < L.n_adapters;
    const int R = L.r;
    if (valid) {
        lora_h<THREADS>(L.x + (size_t)s * L.d_in, L.a + (size_t)id * L.d_in * R, L.d_in, R,
                        red, hl, tid);
    }
    const float gate = id != 0 ? 1.f : 0.f;
    const int p = min(max(pos0, 0), L.max_len - 1);
    constexpr int HALF = D / 2;
    const size_t ld = (size_t)H * D;
    for (int idx = tid; idx < ROW_TILE * HALF; idx += THREADS) {
        const int r = idx / HALF;
        const int c = idx % HALF;
        float q1 = 0.f, q2 = 0.f;
        if (r < nrows) {
            const int hq = h * group + (r0 + r) % group;   // T = 1: every row is token 0
            float d1 = 0.f, d2 = 0.f;
            if (valid) {
                const bf16* b = L.b + (size_t)id * R * ld + (size_t)hq * D + c;
#pragma unroll 8
                for (int k = 0; k < R; ++k) {
                    d1 = fmaf(hl[k], __bfloat162float(b[k * ld]), d1);
                    d2 = fmaf(hl[k], __bfloat162float(b[k * ld + HALF]), d2);
                }
            }
            const float cs = L.cos[(size_t)p * HALF + c];
            const float sn = L.sin[(size_t)p * HALF + c];
            const float e1 = __fsub_rn(__fmul_rn(d1, cs), __fmul_rn(d2, sn));
            const float e2 = __fadd_rn(__fmul_rn(d2, cs), __fmul_rn(d1, sn));
            const bf16* qb = q + ((size_t)s * H + hq) * D;
            q1 = __fadd_rn(__bfloat162float(qb[c]), __fmul_rn(gate, e1));
            q2 = __fadd_rn(__bfloat162float(qb[c + HALF]), __fmul_rn(gate, e2));
        }
        Qs[r * QS + c] = q1;
        Qs[r * QS + c + HALF] = q2;
    }
}

template <typename E, int D, int ROW_TILE, int RG>
__global__ void __launch_bounds__(D * RG)
paged_attention_kernel(const bf16* __restrict__ q,
                       const E* __restrict__ k_pages,
                       const E* __restrict__ v_pages,
                       const float* __restrict__ k_scales,
                       const float* __restrict__ v_scales,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ positions,
                       bf16* __restrict__ out,
                       int T, int H, int Hkv, int P, int page, int n,
                       int pos_stride, float sm_scale, const LoraArgs lora) {
    using Cfg = Tile<E, D, ROW_TILE, RG>;
    constexpr bool QUANT = PageElem<E>::kQuant;
    constexpr int THREADS = Cfg::kThreads;
    constexpr int RPT = Cfg::kRowsPerThread;
    constexpr int CH = Cfg::kChunks;
    constexpr int QS = Cfg::kQStride;
    constexpr int EPL = Cfg::kPerLoad;
    constexpr int KS = Cfg::kStride;
    constexpr int PS = Cfg::kPStride;

    const int s = blockIdx.x;
    const int h = blockIdx.y;
    const int group = H / Hkv;
    const int r0 = blockIdx.z * ROW_TILE;
    const int nrows = min(ROW_TILE, T * group - r0);
    const int tid = threadIdx.x;

    extern __shared__ __align__(16) unsigned char smem[];
    float* Qs = reinterpret_cast<float*>(smem);
    E* Ks = reinterpret_cast<E*>(Qs + ROW_TILE * QS);
    E* Vs = Ks + page * KS;
    float* Ps = reinterpret_cast<float*>(Vs + page * D);
    float* m_s = Ps + page * PS;
    float* l_s = m_s + ROW_TILE;
    float* a_s = l_s + ROW_TILE;

    const int pos0 = positions[(size_t)s * pos_stride];

    float* red = a_s + ROW_TILE;
    lora_query_tile<D, ROW_TILE, THREADS>(lora, q, Qs, QS, red,
                                          red + THREADS / 32 * kMaxLoraRank, s, h, H,
                                          group, r0, nrows, pos0, tid);
    for (int r = tid; r < ROW_TILE; r += THREADS) {
        m_s[r] = -INFINITY;
        l_s[r] = 0.f;
        a_s[r] = 1.f;
    }

    const int d = tid % D;
    const int rg = tid / D;
    float acc[RPT];
#pragma unroll
    for (int k = 0; k < RPT; ++k) acc[k] = 0.f;

    // pages past the last row's position are dead for every row of the tile
    const int last_pos = pos0 + (r0 + nrows - 1) / group;
    const int last_page = last_pos < 0 ? -1 : min(last_pos / page, n - 1);
    __syncthreads();

    for (int j = 0; j <= last_page; ++j) {
        const int pid = block_tables[(size_t)s * n + j];
        const size_t base = ((size_t)h * P + pid) * (size_t)page * D;
        // the page's dequantization scales, amax / QMAX in f32
        float k_scale = 1.f, v_scale = 1.f;
        if constexpr (QUANT) {
            k_scale = k_scales[(size_t)h * P + pid] / PageElem<E>::kQmax;
            v_scale = v_scales[(size_t)h * P + pid] / PageElem<E>::kQmax;
        }
        for (int c = tid; c < page * (D / EPL); c += THREADS) {
            const int t = c / (D / EPL);
            const int col = (c % (D / EPL)) * EPL;
            const size_t off = base + (size_t)t * D + col;
            *reinterpret_cast<uint4*>(Ks + t * KS + col) =
                *reinterpret_cast<const uint4*>(k_pages + off);
            *reinterpret_cast<uint4*>(Vs + t * D + col) =
                *reinterpret_cast<const uint4*>(v_pages + off);
        }
        __syncthreads();

        // scores, masked against each row's own position
        const int kv_start = j * page;
        for (int idx = tid; idx < nrows * page; idx += THREADS) {
            const int r = idx / page;
            const int t = idx % page;
            float dot = 0.f;
            const float4* qrow = reinterpret_cast<const float4*>(Qs + r * QS);
            if constexpr (QUANT) {
                const uint2* krow = reinterpret_cast<const uint2*>(Ks + t * KS);
#pragma unroll
                for (int c = 0; c < CH; ++c)
                    dot += dot8_f32_codes<E>(qrow[2 * c], qrow[2 * c + 1], krow[c], k_scale);
            } else {
                const uint4* krow = reinterpret_cast<const uint4*>(Ks + t * KS);
#pragma unroll
                for (int c = 0; c < CH; ++c) dot += dot8_f32(qrow[2 * c], qrow[2 * c + 1], krow[c]);
            }
            float sc = dot * sm_scale;
            if (kv_start + t > pos0 + (r0 + r) / group) sc = kMaskValue;
            Ps[t * PS + r] = sc;
        }
        __syncthreads();

        // online-softmax statistics, one warp per row
        const int warp = tid / 32;
        const int lane = tid % 32;
        for (int r = warp; r < nrows; r += THREADS / 32) {
            float mx = -INFINITY;
            for (int t = lane; t < page; t += 32) mx = fmaxf(mx, Ps[t * PS + r]);
            mx = warp_max(mx);
            const float m_prev = m_s[r];
            const float m_new = fmaxf(m_prev, mx);
            float sum = 0.f;
            for (int t = lane; t < page; t += 32) {
                const float p = expf(Ps[t * PS + r] - m_new);
                Ps[t * PS + r] = p;
                sum += p;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float alpha = expf(m_prev - m_new);
                l_s[r] = alpha * l_s[r] + sum;
                m_s[r] = m_new;
                a_s[r] = alpha;
            }
        }
        __syncthreads();

        // acc = acc * alpha + p . v, in f32
#pragma unroll
        for (int k = 0; k < RPT; ++k) acc[k] *= a_s[rg * RPT + k];
        for (int t = 0; t < page; ++t) {
            float v;
            if constexpr (QUANT) {
                v = PageElem<E>::widen(reinterpret_cast<const uint8_t*>(Vs)[t * D + d]) * v_scale;
            } else {
                v = __bfloat162float(Vs[t * D + d]);
            }
            const float4* prow = reinterpret_cast<const float4*>(Ps + t * PS + rg * RPT);
#pragma unroll
            for (int k4 = 0; k4 < RPT / 4; ++k4) {
                const float4 p = prow[k4];
                acc[4 * k4 + 0] = fmaf(p.x, v, acc[4 * k4 + 0]);
                acc[4 * k4 + 1] = fmaf(p.y, v, acc[4 * k4 + 1]);
                acc[4 * k4 + 2] = fmaf(p.z, v, acc[4 * k4 + 2]);
                acc[4 * k4 + 3] = fmaf(p.w, v, acc[4 * k4 + 3]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int k = 0; k < RPT; ++k) {
        const int r = rg * RPT + k;
        if (r < nrows) {
            const float l = l_s[r];
            const int gr = r0 + r;
            const int tok = gr / group;
            const int g = gr % group;
            out[(((size_t)s * T + tok) * H + (size_t)h * group + g) * D + d] =
                __float2bfloat16(acc[k] / (l == 0.f ? 1.f : l));
        }
    }
}

template <typename E, int D, int ROW_TILE, int RG>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales,
                   const void* block_tables, const void* positions, void* out,
                   int S, int T, int H, int Hkv, int P, int page, int n,
                   int pos_stride, float sm_scale, const LoraArgs& lora, cudaStream_t stream) {
    using Cfg = Tile<E, D, ROW_TILE, RG>;
    const int rows = T * (H / Hkv);
    const dim3 grid(S, Hkv, (rows + ROW_TILE - 1) / ROW_TILE);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
    const size_t smem = Cfg::smem_bytes(page);
    auto kernel = paged_attention_kernel<E, D, ROW_TILE, RG>;
    // raise the kernel's shared-memory limit once per device and size, not
    // on every launch (a launch may be captured into a CUDA graph)
    static size_t smem_allowed[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (smem > 48 * 1024 && (dev >= 64 || smem > smem_allowed[dev])) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        if (dev < 64) smem_allowed[dev] = smem;
    }
    kernel<<<grid, Cfg::kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const E*>(k_pages),
        static_cast<const E*>(v_pages), static_cast<const float*>(k_scales),
        static_cast<const float*>(v_scales), static_cast<const int*>(block_tables),
        static_cast<const int*>(positions), static_cast<bf16*>(out),
        T, H, Hkv, P, page, n, pos_stride, sm_scale, lora);
    return cudaGetLastError();
}

template <typename E, int ROW_TILE, int RG>
int dispatch(int device, const void* q, const void* k_pages, const void* v_pages,
             const void* k_scales, const void* v_scales,
             const void* block_tables, const void* positions, void* out,
             int S, int T, int H, int Hkv, int D, int P, int page, int n,
             int pos_stride, float sm_scale, void* stream, const LoraArgs& lora) {
    if (S <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0 || n <= 0)
        return (int)cudaErrorInvalidValue;
    if (PageElem<E>::kQuant && (k_scales == nullptr || v_scales == nullptr))
        return (int)cudaErrorInvalidValue;
    if (T != 1 || lora.r < 1 || lora.r > kMaxLoraRank || lora.d_in <= 0 ||
        lora.n_adapters <= 0 || lora.max_len <= 0 || D % 2 != 0)
        return (int)cudaErrorInvalidValue;
    // launch on the tensors' device, and leave the caller's current device
    // as it was
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 64:
            err = launch<E, 64, ROW_TILE, RG>(q, k_pages, v_pages, k_scales, v_scales,
                                       block_tables, positions, out, S, T, H, Hkv, P,
                                              page, n, pos_stride, sm_scale, lora, st);
            break;
        case 96:
            err = launch<E, 96, ROW_TILE, RG>(q, k_pages, v_pages, k_scales, v_scales,
                                       block_tables, positions, out, S, T, H, Hkv, P,
                                              page, n, pos_stride, sm_scale, lora, st);
            break;
        case 128:
            err = launch<E, 128, ROW_TILE, RG>(q, k_pages, v_pages, k_scales, v_scales,
                                        block_tables, positions, out, S, T, H, Hkv, P,
                                               page, n, pos_stride, sm_scale, lora, st);
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

// Fused LoRA query + decode: q_base / out [S, H, D] (q_base already roped),
// positions [S], x [S, d_in], a_stack [N, d_in, r], b_stack [N, r, H * D],
// ids [S], cos / sin [max_len, D / 2] f32; k_scales / v_scales NULL for bf16
// pages.  Rows per block: the GQA group, up to 8.
#define FUSED_ENTRY(name, E)                                                              \
    int name(int device, const void* q_base, const void* x, const void* a_stack,        \
             const void* b_stack, const void* ids, const void* cos, const void* sin,     \
             const void* k_pages, const void* v_pages, const void* k_scales,             \
             const void* v_scales, const void* block_tables, const void* positions,      \
             void* out, int S, int H, int Hkv, int D, int P, int page, int n, int d_in,   \
             int r, int n_adapters, int max_len, float sm_scale, void* stream) {          \
        LoraArgs lora;                                                                   \
        lora.x = static_cast<const bf16*>(x);                                            \
        lora.a = static_cast<const bf16*>(a_stack);                                      \
        lora.b = static_cast<const bf16*>(b_stack);                                      \
        lora.ids = static_cast<const int*>(ids);                                         \
        lora.cos = static_cast<const float*>(cos);                                       \
        lora.sin = static_cast<const float*>(sin);                                       \
        lora.d_in = d_in;                                                                \
        lora.r = r;                                                                      \
        lora.n_adapters = n_adapters;                                                    \
        lora.max_len = max_len;                                                          \
        return dispatch<E, 8, 1>(device, q_base, k_pages, v_pages, k_scales, v_scales,  \
                                 block_tables, positions, out, S, 1, H, Hkv, D, P, page, \
                                 n, 1, sm_scale, stream, lora);                         \
    }

FUSED_ENTRY(fused_bgmv_paged_decode_bf16, bf16)
FUSED_ENTRY(fused_bgmv_paged_decode_int8, int8_t)
FUSED_ENTRY(fused_bgmv_paged_decode_fp8, fp8)
#undef FUSED_ENTRY

const char* paged_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
