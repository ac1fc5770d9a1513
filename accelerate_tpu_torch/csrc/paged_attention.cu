// Paged attention for the serving engine, hand-written for Hopper (sm_90a).
//
// Two entry points share one kernel template:
//
//   paged_decode_attention_bf16      replaces the Pallas TPU kernel
//       accelerate_tpu/ops/flash_attention.py  _paged_decode_kernel
//       (launched by paged_decode_attention): ragged T = 1 decode, one
//       query token per slot, once per layer on every decode step.
//   paged_multitoken_attention_bf16  replaces the Pallas TPU kernel
//       accelerate_tpu/ops/flash_attention.py  _paged_multitoken_kernel
//       (launched by paged_multitoken_attention): a window of T contiguous
//       query tokens per slot, once per layer on every prefill chunk.
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
// (min(last_row_pos / page, n - 1)).  Row tiles split the T * group query
// rows of a prefill chunk over many blocks: a 512-token chunk of the 600m
// model (group 2) makes 16 tiles of 64 rows per kv head, 128 blocks in all,
// where one block per kv head would leave most of the 132 SMs idle.
//
// What bounds it on an H100:
//   * decode reads every live K/V page once for 16 or so query rows per
//     kv head: it is bound by HBM bytes (the live pages over 3.35 TB/s);
//   * a 512-token prefill chunk does about 2 * 512 * 2 flops per kv
//     element it reads and sits near the compute/bandwidth ridge.
// This first version is plain CUDA cores, one page in flight per block and
// a barrier between the load and the math.  The faster forms (wgmma tiles,
// TMA loads double-buffered, decode split over pages) are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (accelerate_tpu_torch/ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

// DEFAULT_MASK_VALUE of the JAX package: finite, so exp(mask - m) is 0 and
// never NaN.
constexpr float kMaskValue = -0.7f * 3.402823466e38f;

__device__ __forceinline__ float dot8(const uint4 a, const uint4 b) {
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 fa = __bfloat1622float2(a2[i]);
        const float2 fb = __bfloat1622float2(b2[i]);
        s = fmaf(fa.x, fb.x, s);
        s = fmaf(fa.y, fb.y, s);
    }
    return s;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// D: head dim; ROW_TILE: query rows per block; RG: row groups, so a block
// has D * RG threads and thread (d, rg) owns output column d of rows
// rg * ROW_TILE / RG .. (rg + 1) * ROW_TILE / RG - 1.
template <int D, int ROW_TILE, int RG>
struct Tile {
    static constexpr int kThreads = D * RG;
    static constexpr int kRowsPerThread = ROW_TILE / RG;
    static constexpr int kChunks = D / 8;        // 16-byte chunks per row
    static constexpr int kStride = D + 8;        // padded bf16 row: an odd number of
                                                 // 16-byte chunks, so the 16-byte
                                                 // reads of 8 lanes hit 32 banks
    static constexpr int kPStride = ROW_TILE + 4;  // p stored [token][row]
    static_assert(D % 8 == 0, "head dim must be a multiple of 8");
    static_assert(kThreads % 32 == 0, "block must be whole warps");
    static_assert(kRowsPerThread % 4 == 0, "rows per thread read as float4");

    static size_t smem_bytes(int page) {
        return sizeof(bf16) * (size_t)(ROW_TILE + page) * kStride   // Q, K
             + sizeof(bf16) * (size_t)page * D                      // V
             + sizeof(float) * (size_t)page * kPStride              // scores / p
             + sizeof(float) * 3 * ROW_TILE;                        // m, l, alpha
    }
};

template <int D, int ROW_TILE, int RG>
__global__ void __launch_bounds__(D * RG)
paged_attention_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k_pages,
                       const bf16* __restrict__ v_pages,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ positions,
                       bf16* __restrict__ out,
                       int T, int H, int Hkv, int P, int page, int n,
                       int pos_stride, float sm_scale) {
    using Cfg = Tile<D, ROW_TILE, RG>;
    constexpr int THREADS = Cfg::kThreads;
    constexpr int RPT = Cfg::kRowsPerThread;
    constexpr int CH = Cfg::kChunks;
    constexpr int KS = Cfg::kStride;
    constexpr int PS = Cfg::kPStride;

    const int s = blockIdx.x;
    const int h = blockIdx.y;
    const int group = H / Hkv;
    const int r0 = blockIdx.z * ROW_TILE;
    const int nrows = min(ROW_TILE, T * group - r0);
    const int tid = threadIdx.x;

    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Ks = Qs + ROW_TILE * KS;
    bf16* Vs = Ks + page * KS;
    float* Ps = reinterpret_cast<float*>(Vs + page * D);
    float* m_s = Ps + page * PS;
    float* l_s = m_s + ROW_TILE;
    float* a_s = l_s + ROW_TILE;

    const int pos0 = positions[(size_t)s * pos_stride];

    // the block's query rows, token-major: row r0 + r is token (r0 + r) / group
    // of q head h * group + (r0 + r) % group
    for (int c = tid; c < ROW_TILE * CH; c += THREADS) {
        const int r = c / CH;
        const int col = (c % CH) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r < nrows) {
            const int gr = r0 + r;
            const int tok = gr / group;
            const int g = gr % group;
            val = *reinterpret_cast<const uint4*>(
                q + (((size_t)s * T + tok) * H + (size_t)h * group + g) * D + col);
        }
        *reinterpret_cast<uint4*>(Qs + r * KS + col) = val;
    }
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
        for (int c = tid; c < page * CH; c += THREADS) {
            const int t = c / CH;
            const int col = (c % CH) * 8;
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
            const uint4* qrow = reinterpret_cast<const uint4*>(Qs + r * KS);
            const uint4* krow = reinterpret_cast<const uint4*>(Ks + t * KS);
            float dot = 0.f;
#pragma unroll
            for (int c = 0; c < CH; ++c) dot += dot8(qrow[c], krow[c]);
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
            const float v = __bfloat162float(Vs[t * D + d]);
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

template <int D, int ROW_TILE, int RG>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* positions, void* out,
                   int S, int T, int H, int Hkv, int P, int page, int n,
                   int pos_stride, float sm_scale, cudaStream_t stream) {
    using Cfg = Tile<D, ROW_TILE, RG>;
    const int rows = T * (H / Hkv);
    const dim3 grid(S, Hkv, (rows + ROW_TILE - 1) / ROW_TILE);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
    const size_t smem = Cfg::smem_bytes(page);
    auto kernel = paged_attention_kernel<D, ROW_TILE, RG>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    kernel<<<grid, Cfg::kThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
        static_cast<const bf16*>(v_pages), static_cast<const int*>(block_tables),
        static_cast<const int*>(positions), static_cast<bf16*>(out),
        T, H, Hkv, P, page, n, pos_stride, sm_scale);
    return cudaGetLastError();
}

template <int ROW_TILE, int RG>
int dispatch(int device, const void* q, const void* k_pages, const void* v_pages,
             const void* block_tables, const void* positions, void* out,
             int S, int T, int H, int Hkv, int D, int P, int page, int n,
             int pos_stride, float sm_scale, void* stream) {
    if (S <= 0 || T <= 0 || Hkv <= 0 || H % Hkv != 0 || page <= 0 || n <= 0)
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
            err = launch<64, ROW_TILE, RG>(q, k_pages, v_pages, block_tables, positions, out,
                                           S, T, H, Hkv, P, page, n, pos_stride, sm_scale, st);
            break;
        case 96:
            err = launch<96, ROW_TILE, RG>(q, k_pages, v_pages, block_tables, positions, out,
                                           S, T, H, Hkv, P, page, n, pos_stride, sm_scale, st);
            break;
        case 128:
            err = launch<128, ROW_TILE, RG>(q, k_pages, v_pages, block_tables, positions, out,
                                            S, T, H, Hkv, P, page, n, pos_stride, sm_scale, st);
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

// Decode: q / out [S, H, D] (T = 1), positions [S].  Rows per block: the
// GQA group, up to 8 (larger groups take several row tiles).
int paged_decode_attention_bf16(int device, const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* positions, void* out, int S, int T, int H,
                                int Hkv, int D, int P, int page, int n,
                                float sm_scale, void* stream) {
    if (T != 1) return (int)cudaErrorInvalidValue;
    return dispatch<8, 1>(device, q, k_pages, v_pages, block_tables, positions, out,
                          S, 1, H, Hkv, D, P, page, n, 1, sm_scale, stream);
}

// Multi-token: q / out [S, T, H, D], positions [S, T] (only column 0 is
// read; rows are contiguous).  Rows per block: 64.
int paged_multitoken_attention_bf16(int device, const void* q, const void* k_pages,
                                    const void* v_pages, const void* block_tables,
                                    const void* positions, void* out, int S, int T,
                                    int H, int Hkv, int D, int P, int page, int n,
                                    float sm_scale, void* stream) {
    return dispatch<64, 2>(device, q, k_pages, v_pages, block_tables, positions, out,
                           S, T, H, Hkv, D, P, page, n, T, sm_scale, stream);
}

const char* paged_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
