// Flash attention for training, hand-written for Hopper (sm_90a).
//
// Three kernels, one per Pallas TPU kernel of
// accelerate_tpu/ops/flash_attention.py:
//
//   flash_attention_fwd_bf16  replaces _attn_kernel (launched by _flash_fwd):
//       out = softmax(q k^T * scale, masked) v and lse = m + log(l);
//   flash_attention_dq_bf16   replaces _dq_kernel (launched by _flash_bwd):
//       dq = ds k, ds = p (dp - delta) * scale, p recomputed from lse;
//   flash_attention_dkv_bf16  replaces _dkv_kernel (launched by _flash_bwd):
//       dk = ds^T q and dv = p^T g, summed over each kv head's GQA group.
//
// Semantics (kept from the Pallas bodies):
//   * q / g / out [B, T, H, D], k / v [B, S, Hkv, D] row-major (the JAX
//     public layout, read in place: no transposes); lse / delta [B, H, T]
//     f32; segment ids / positions [B, T] and [B, S] int32 or NULL; q head
//     h reads kv head h / (H / Hkv);
//   * scores are bf16 q . k accumulated in f32, times sm_scale; a pair is
//     valid iff the row and column are in bounds, the row is not before the
//     column (by index, or by position when positions are given, only when
//     causal) and the segment ids agree; invalid pairs score the finite
//     DEFAULT_MASK_VALUE -0.7 * FLT_MAX (columns past S are left out);
//   * forward: the online softmax starts at m = -inf, l = 0; p is rounded to
//     bf16 before p . v; out = acc / l (by 1 where l == 0) in bf16;
//   * backward: p = exp(s - lse) and ds = p (dp - delta) * scale, both
//     hard-zeroed off the valid set; delta = rowsum(g . out) - g_lse comes
//     in from the caller; ds and p are rounded to bf16 before their
//     products.
//
// Tiles: 64 query rows by 64 keys, four warps of 16 rows each (forward
// and dq ask for three blocks per SM, dkv fits two); every
// product is mma.sync m16n8k16 bf16 with f32 accumulation, operands read
// from shared memory with ldmatrix.  K/V tiles (forward, dq) and Q/g tiles
// (dkv) are double-buffered with cp.async, so the next tile's load runs
// under this tile's math.  Tiles wholly inside the mask (below the causal
// diagonal, in bounds, no segments or positions) skip the per-element mask
// arithmetic.  Shared-memory rows are padded to D + 8
// elements: an odd number of 16-byte chunks, so ldmatrix's eight row
// reads fall in distinct banks.
//
// Grid, and what replaces the TPU's serial grid axis:
//   * forward and dq: one block per (query tile, batch * q head); the block
//     walks the key tiles itself, up to the diagonal when causal by index,
//     over all of them when positions are given (the diagonal is then data
//     dependent, as in the Pallas skip rule).  Query tiles run heaviest
//     first so the causal tail is short;
//   * dkv: one block per (key tile, batch * kv head); the block walks every
//     (group member, query tile) pair itself and keeps the dk / dv sums in
//     registers, so the GQA group sum needs no atomics and two runs give
//     bitwise-equal gradients.
//
// What bounds them on an H100: at the 600m training shape (B 10, T 2048,
// 16 q / 8 kv heads, D 96, causal) the forward does 4 * D flops per
// unmasked (row, key) pair and reads ~190 MB, so it is bound by the tensor
// cores (~0.13 ms at 989 TFLOP/s), dq by 6 and dkv by 8 flops per pair.
// mma.sync reaches a fraction of that peak; wgmma, TMA and warp
// specialisation are the later steps.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (accelerate_tpu_torch/ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kMaskValue = -0.7f * 3.402823466e38f;
constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // four warps of 16 rows

struct Params {
    const bf16* q;
    const bf16* k;
    const bf16* v;
    const int* seg_q;
    const int* seg_kv;
    const int* pos_q;
    const int* pos_kv;
    const bf16* g;
    const float* lse_in;
    const float* delta;
    bf16* out;
    float* lse_out;
    bf16* dq;
    bf16* dk;
    bf16* dv;
    int B, T, S, H, Hkv, causal;
    float sm_scale;
};

// -- PTX helpers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
    const int n = pred ? 16 : 0;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] . b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -- fragment loads from a row-major shared tile of row stride LD --------
//
// mma fragments (g = lane / 4, t = lane % 4):
//   A 16x16: a0 = A[g][2t..], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]
//   B 16x8:  b0 = B[2t..][g], b1 = B[2t+8..][g]
//   C 16x8:  c0,c1 = C[g][2t, 2t+1], c2,c3 = C[g+8][2t, 2t+1]

// A = tile[r0:r0+16, c0:c0+16]
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* tile, int r0, int c0, int lane) {
    const int mat = lane >> 3;
    const int row = r0 + (lane & 7) + ((mat & 1) << 3);
    const int col = c0 + ((mat >> 1) << 3);
    ldsm_x4(a, tile + row * LD + col);
}

// B[k][n] = tile[n][k] for n in n0..n0+15, k in k0..k0+15:
// b[0], b[1] for the n-tile at n0, b[2], b[3] for the one at n0 + 8
template <int LD>
__device__ __forceinline__ void load_b_rows(uint32_t* b, const bf16* tile, int n0, int k0, int lane) {
    const int mat = lane >> 3;
    const int row = n0 + (lane & 7) + ((mat >> 1) << 3);
    const int col = k0 + ((mat & 1) << 3);
    ldsm_x4(b, tile + row * LD + col);
}

// B[k][n] = tile[k][n] for k in k0..k0+15, n in n0..n0+15 (transposed load)
template <int LD>
__device__ __forceinline__ void load_b_cols(uint32_t* b, const bf16* tile, int k0, int n0, int lane) {
    const int mat = lane >> 3;
    const int row = k0 + (lane & 7) + ((mat & 1) << 3);
    const int col = n0 + ((mat >> 1) << 3);
    ldsm_x4_t(b, tile + row * LD + col);
}

// rows row0 .. row0 + ROWS - 1 of a strided global array (D contiguous
// elements per row) into tile[ROWS][LD]; rows at or past `limit` are zeros
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, size_t row_stride,
                                          int row0, int limit, int tid) {
    constexpr int CH = D / 8;
    for (int c = tid; c < ROWS * CH; c += THREADS) {
        const int r = c / CH;
        const int col = (c % CH) * 8;
        const int row = row0 + r;
        const bool ok = row < limit;
        cp_async16(tile + r * LD + col, base + (size_t)(ok ? row : 0) * row_stride + col, ok);
    }
}

// int32 ids of rows row0 .. row0 + n - 1 (0 past limit / when absent)
__device__ __forceinline__ void load_ids(int* dst, const int* src, int row0, int limit,
                                         int n, int tid) {
    for (int i = tid; i < n; i += THREADS) {
        const int row = row0 + i;
        dst[i] = (src != nullptr && row < limit) ? src[row] : 0;
    }
}

// whether query row `row` (ids sq, pq) attends key `col` (ids sk, pk)
__device__ __forceinline__ bool attends(const Params& p, bool segmented, bool positioned,
                                        int row, int col, int sq, int sk, int pq, int pk) {
    bool ok = row < p.T && col < p.S;
    if (p.causal) ok = ok && (positioned ? pq >= pk : row >= col);
    if (segmented) ok = ok && sq == sk;
    return ok;
}

// whether every (row, key) pair of a tile attends, so the tile needs no
// mask: in bounds, no segments or positions, wholly below the diagonal
__device__ __forceinline__ bool tile_unmasked(const Params& p, bool segmented, bool positioned,
                                              int q0, int k0) {
    return !segmented && !positioned && q0 + BQ <= p.T && k0 + BK <= p.S &&
           (!p.causal || q0 >= k0 + BK - 1);
}

// -- kernel #1: forward --------------------------------------------------

template <int D>
struct Fwd {
    static constexpr int LD = D + 8;
    static constexpr size_t smem() {
        return sizeof(bf16) * (size_t)(BQ + 4 * BK) * LD + sizeof(int) * 4 * BK;
    }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 3) flash_fwd_kernel(const Params p) {
    constexpr int LD = D + 8;
    constexpr int KS = D / 16;  // k-steps over the head dim
    constexpr int DT = D / 8;   // n-tiles over the head dim
    constexpr int NT = BK / 8;  // n-tiles over a key tile

    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Ks = Qs + BQ * LD;       // [2][BK][LD]
    bf16* Vs = Ks + 2 * BK * LD;   // [2][BK][LD]
    int* ids = reinterpret_cast<int*>(Vs + 2 * BK * LD);  // seg [2][BK], pos [2][BK]

    const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
    const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
    const int hk = h / (p.H / p.Hkv);
    const int q0 = qt * BQ;
    const bool segmented = p.seg_q != nullptr, positioned = p.pos_q != nullptr;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
    int sq[2] = {0, 0}, pq[2] = {0, 0};
    for (int r = 0; r < 2; ++r) {
        if (row[r] < p.T) {
            if (segmented) sq[r] = p.seg_q[(size_t)b * p.T + row[r]];
            if (positioned) pq[r] = p.pos_q[(size_t)b * p.T + row[r]];
        }
    }

    const bf16* qbase = p.q + ((size_t)b * p.T * p.H + h) * D;
    const bf16* kbase = p.k + ((size_t)b * p.S * p.Hkv + hk) * D;
    const bf16* vbase = p.v + ((size_t)b * p.S * p.Hkv + hk) * D;
    const size_t kv_stride = (size_t)p.Hkv * D;
    int n_kt = (p.S + BK - 1) / BK;
    if (p.causal && !positioned) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

    auto load_kv = [&](int kt, int stage) {
        load_tile<D, LD, BK>(Ks + stage * BK * LD, kbase, kv_stride, kt * BK, p.S, tid);
        load_tile<D, LD, BK>(Vs + stage * BK * LD, vbase, kv_stride, kt * BK, p.S, tid);
        const int* seg = segmented ? p.seg_kv + (size_t)b * p.S : nullptr;
        const int* pos = positioned ? p.pos_kv + (size_t)b * p.S : nullptr;
        load_ids(ids + stage * BK, seg, kt * BK, p.S, BK, tid);
        load_ids(ids + (2 + stage) * BK, pos, kt * BK, p.S, BK, tid);
    };

    load_tile<D, LD, BQ>(Qs, qbase, (size_t)p.H * D, q0, p.T, tid);
    load_kv(0, 0);
    cp_async_commit();

    uint32_t qf[KS][4];
    float acc[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int kt = 0; kt < n_kt; ++kt) {
        const int stage = kt & 1;
        if (kt + 1 < n_kt) {
            load_kv(kt + 1, stage ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        if (kt == 0) {
#pragma unroll
            for (int ks = 0; ks < KS; ++ks) load_a<LD>(qf[ks], Qs, warp * 16, ks * 16, lane);
        }
        const bf16* Kt = Ks + stage * BK * LD;
        const bf16* Vt = Vs + stage * BK * LD;
        const int* sk = ids + stage * BK;
        const int* pk = ids + (2 + stage) * BK;

        float s[NT][4];
#pragma unroll
        for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t bf[4];
                load_b_rows<LD>(bf, Kt, np * 16, ks * 16, lane);
                mma(s[2 * np], qf[ks], bf[0], bf[1]);
                mma(s[2 * np + 1], qf[ks], bf[2], bf[3]);
            }
        }

        const int k0 = kt * BK;
        const bool unmasked = tile_unmasked(p, segmented, positioned, q0, k0);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                float x = s[nt][e] * p.sm_scale;
                if (!unmasked) {
                    const int lc = nt * 8 + 2 * t4 + (e & 1);
                    const int col = k0 + lc;
                    if (col >= p.S)
                        x = -INFINITY;
                    else if (!attends(p, segmented, positioned, row[r], col, sq[r], sk[lc],
                                      pq[r], pk[lc]))
                        x = kMaskValue;
                }
                s[nt][e] = x;
                mx[r] = fmaxf(mx[r], x);
            }
        }
        float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], quad_max(mx[r]));
            alpha[r] = __expf(m[r] - m_new);
            m[r] = m_new;
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float pe = __expf(s[nt][e] - m[e >> 1]);
                s[nt][e] = pe;
                rs[e >> 1] += pe;
            }
        }
        l[0] = l[0] * alpha[0] + rs[0];
        l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
            acc[dt][0] *= alpha[0];
            acc[dt][1] *= alpha[0];
            acc[dt][2] *= alpha[1];
            acc[dt][3] *= alpha[1];
        }
        // acc += bf16(p) . v
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                    pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                    pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                    pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int dp = 0; dp < DT / 2; ++dp) {
                uint32_t bf[4];
                load_b_cols<LD>(bf, Vt, kk * 16, dp * 16, lane);
                mma(acc[2 * dp], pa, bf[0], bf[1]);
                mma(acc[2 * dp + 1], pa, bf[2], bf[3]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float lt = quad_sum(l[r]);
        const float safe_l = lt == 0.f ? 1.f : lt;
        if (row[r] >= p.T) continue;
        bf16* orow = p.out + (((size_t)b * p.T + row[r]) * p.H + h) * D + 2 * t4;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
            *reinterpret_cast<uint32_t*>(orow + dt * 8) =
                pack_bf16(acc[dt][2 * r] / safe_l, acc[dt][2 * r + 1] / safe_l);
        }
        if (t4 == 0) p.lse_out[((size_t)b * p.H + h) * p.T + row[r]] = m[r] + logf(safe_l);
    }
}

// -- kernel #2: dq -------------------------------------------------------

template <int D>
struct Dq {
    static constexpr int LD = D + 8;
    static constexpr size_t smem() {
        return sizeof(bf16) * (size_t)(2 * BQ + 4 * BK) * LD + sizeof(int) * 4 * BK;
    }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 3) flash_dq_kernel(const Params p) {
    constexpr int LD = D + 8;
    constexpr int KS = D / 16;
    constexpr int DT = D / 8;
    constexpr int NT = BK / 8;

    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Gs = Qs + BQ * LD;
    bf16* Ks = Gs + BQ * LD;       // [2][BK][LD]
    bf16* Vs = Ks + 2 * BK * LD;   // [2][BK][LD]
    int* ids = reinterpret_cast<int*>(Vs + 2 * BK * LD);

    const int qt = gridDim.x - 1 - blockIdx.x;
    const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
    const int hk = h / (p.H / p.Hkv);
    const int q0 = qt * BQ;
    const bool segmented = p.seg_q != nullptr, positioned = p.pos_q != nullptr;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
    int sq[2] = {0, 0}, pq[2] = {0, 0};
    float lse[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
    for (int r = 0; r < 2; ++r) {
        if (row[r] < p.T) {
            if (segmented) sq[r] = p.seg_q[(size_t)b * p.T + row[r]];
            if (positioned) pq[r] = p.pos_q[(size_t)b * p.T + row[r]];
            lse[r] = p.lse_in[((size_t)b * p.H + h) * p.T + row[r]];
            delta[r] = p.delta[((size_t)b * p.H + h) * p.T + row[r]];
        }
    }

    const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.Hkv * D;
    const bf16* kbase = p.k + ((size_t)b * p.S * p.Hkv + hk) * D;
    const bf16* vbase = p.v + ((size_t)b * p.S * p.Hkv + hk) * D;
    int n_kt = (p.S + BK - 1) / BK;
    if (p.causal && !positioned) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

    auto load_kv = [&](int kt, int stage) {
        load_tile<D, LD, BK>(Ks + stage * BK * LD, kbase, kv_stride, kt * BK, p.S, tid);
        load_tile<D, LD, BK>(Vs + stage * BK * LD, vbase, kv_stride, kt * BK, p.S, tid);
        const int* seg = segmented ? p.seg_kv + (size_t)b * p.S : nullptr;
        const int* pos = positioned ? p.pos_kv + (size_t)b * p.S : nullptr;
        load_ids(ids + stage * BK, seg, kt * BK, p.S, BK, tid);
        load_ids(ids + (2 + stage) * BK, pos, kt * BK, p.S, BK, tid);
    };

    load_tile<D, LD, BQ>(Qs, p.q + ((size_t)b * p.T * p.H + h) * D, q_stride, q0, p.T, tid);
    load_tile<D, LD, BQ>(Gs, p.g + ((size_t)b * p.T * p.H + h) * D, q_stride, q0, p.T, tid);
    load_kv(0, 0);
    cp_async_commit();

    float dq[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

    for (int kt = 0; kt < n_kt; ++kt) {
        const int stage = kt & 1;
        if (kt + 1 < n_kt) {
            load_kv(kt + 1, stage ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* Kt = Ks + stage * BK * LD;
        const bf16* Vt = Vs + stage * BK * LD;
        const int* sk = ids + stage * BK;
        const int* pk = ids + (2 + stage) * BK;

        // s = q k^T, dp = g v^T
        float s[NT][4], dpv[NT][4];
#pragma unroll
        for (int i = 0; i < NT; ++i) {
            s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
            dpv[i][0] = dpv[i][1] = dpv[i][2] = dpv[i][3] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            uint32_t qa[4], ga[4];
            load_a<LD>(qa, Qs, warp * 16, ks * 16, lane);
            load_a<LD>(ga, Gs, warp * 16, ks * 16, lane);
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t bf[4];
                load_b_rows<LD>(bf, Kt, np * 16, ks * 16, lane);
                mma(s[2 * np], qa, bf[0], bf[1]);
                mma(s[2 * np + 1], qa, bf[2], bf[3]);
                load_b_rows<LD>(bf, Vt, np * 16, ks * 16, lane);
                mma(dpv[2 * np], ga, bf[0], bf[1]);
                mma(dpv[2 * np + 1], ga, bf[2], bf[3]);
            }
        }
        // ds = p (dp - delta) * scale, p = exp(s - lse), zero off the mask
        const int k0 = kt * BK;
        const bool unmasked = tile_unmasked(p, segmented, positioned, q0, k0);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const int lc = nt * 8 + 2 * t4 + (e & 1);
                float ds = 0.f;
                if (unmasked || attends(p, segmented, positioned, row[r], k0 + lc, sq[r],
                                        sk[lc], pq[r], pk[lc])) {
                    const float pe = __expf(s[nt][e] * p.sm_scale - lse[r]);
                    ds = pe * (dpv[nt][e] - delta[r]) * p.sm_scale;
                }
                s[nt][e] = ds;
            }
        }
        // dq += bf16(ds) . k
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const uint32_t da[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                    pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                    pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                    pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int dp = 0; dp < DT / 2; ++dp) {
                uint32_t bf[4];
                load_b_cols<LD>(bf, Kt, kk * 16, dp * 16, lane);
                mma(dq[2 * dp], da, bf[0], bf[1]);
                mma(dq[2 * dp + 1], da, bf[2], bf[3]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (row[r] >= p.T) continue;
        bf16* drow = p.dq + (((size_t)b * p.T + row[r]) * p.H + h) * D + 2 * t4;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
            *reinterpret_cast<uint32_t*>(drow + dt * 8) = pack_bf16(dq[dt][2 * r], dq[dt][2 * r + 1]);
    }
}

// -- kernel #3: dk, dv ---------------------------------------------------

template <int D>
struct Dkv {
    static constexpr int LD = D + 8;
    static constexpr size_t smem() {
        // K, V once; Q and g double-buffered; per stage lse, delta, seg, pos
        return sizeof(bf16) * (size_t)(2 * BK + 4 * BQ) * LD + sizeof(float) * 8 * BQ;
    }
};

template <int D>
__global__ void __launch_bounds__(THREADS) flash_dkv_kernel(const Params p) {
    constexpr int LD = D + 8;
    constexpr int KS = D / 16;
    constexpr int DT = D / 8;
    constexpr int NT = BQ / 8;  // n-tiles over a query tile

    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Ks = reinterpret_cast<bf16*>(smem);
    bf16* Vs = Ks + BK * LD;
    bf16* Qs = Vs + BK * LD;       // [2][BQ][LD]
    bf16* Gs = Qs + 2 * BQ * LD;   // [2][BQ][LD]
    float* rows = reinterpret_cast<float*>(Gs + 2 * BQ * LD);  // [2][4][BQ]

    const int kt = blockIdx.x;
    const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
    const int group = p.H / p.Hkv;
    const int k0 = kt * BK;
    const bool segmented = p.seg_q != nullptr, positioned = p.pos_q != nullptr;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
    int sk[2] = {0, 0}, pk[2] = {0, 0};
    for (int r = 0; r < 2; ++r) {
        if (key[r] < p.S) {
            if (segmented) sk[r] = p.seg_kv[(size_t)b * p.S + key[r]];
            if (positioned) pk[r] = p.pos_kv[(size_t)b * p.S + key[r]];
        }
    }

    const size_t q_stride = (size_t)p.H * D, kv_stride = (size_t)p.Hkv * D;
    const int n_qt = (p.T + BQ - 1) / BQ;
    // query tiles with a row at or after this tile's first key (causal by index)
    const int qt_first = (p.causal && !positioned) ? min(k0 / BQ, n_qt) : 0;
    const int per_head = n_qt - qt_first;
    const int n_it = group * per_head;

    auto load_q = [&](int it, int stage) {
        const int h = hk * group + it / per_head;
        const int q0 = (qt_first + it % per_head) * BQ;
        const size_t head = ((size_t)b * p.T * p.H + h) * D;
        load_tile<D, LD, BQ>(Qs + stage * BQ * LD, p.q + head, q_stride, q0, p.T, tid);
        load_tile<D, LD, BQ>(Gs + stage * BQ * LD, p.g + head, q_stride, q0, p.T, tid);
        float* rs = rows + stage * 4 * BQ;
        for (int i = tid; i < BQ; i += THREADS) {
            const int row = q0 + i;
            const bool ok = row < p.T;
            const size_t lrow = ((size_t)b * p.H + h) * p.T + row;
            rs[i] = ok ? p.lse_in[lrow] : 0.f;
            rs[BQ + i] = ok ? p.delta[lrow] : 0.f;
            reinterpret_cast<int*>(rs)[2 * BQ + i] =
                (ok && segmented) ? p.seg_q[(size_t)b * p.T + row] : 0;
            reinterpret_cast<int*>(rs)[3 * BQ + i] =
                (ok && positioned) ? p.pos_q[(size_t)b * p.T + row] : 0;
        }
    };

    float dk[DT][4], dv[DT][4];
#pragma unroll
    for (int i = 0; i < DT; ++i) {
        dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
        dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
    }

    if (n_it > 0) {
        load_tile<D, LD, BK>(Ks, p.k + ((size_t)b * p.S * p.Hkv + hk) * D, kv_stride, k0, p.S, tid);
        load_tile<D, LD, BK>(Vs, p.v + ((size_t)b * p.S * p.Hkv + hk) * D, kv_stride, k0, p.S, tid);
        load_q(0, 0);
        cp_async_commit();
    }

    for (int it = 0; it < n_it; ++it) {
        const int stage = it & 1;
        if (it + 1 < n_it) {
            load_q(it + 1, stage ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* Qt = Qs + stage * BQ * LD;
        const bf16* Gt = Gs + stage * BQ * LD;
        const float* lse = rows + stage * 4 * BQ;
        const float* delta = lse + BQ;
        const int* sq = reinterpret_cast<const int*>(lse) + 2 * BQ;
        const int* pq = reinterpret_cast<const int*>(lse) + 3 * BQ;
        const int q0 = (qt_first + it % per_head) * BQ;

        // s^T = k q^T and dp^T = v g^T: rows are this warp's keys
        float st[NT][4], dpt[NT][4];
#pragma unroll
        for (int i = 0; i < NT; ++i) {
            st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;
            dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
            uint32_t ka[4], va[4];
            load_a<LD>(ka, Ks, warp * 16, ks * 16, lane);
            load_a<LD>(va, Vs, warp * 16, ks * 16, lane);
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
                uint32_t bf[4];
                load_b_rows<LD>(bf, Qt, np * 16, ks * 16, lane);
                mma(st[2 * np], ka, bf[0], bf[1]);
                mma(st[2 * np + 1], ka, bf[2], bf[3]);
                load_b_rows<LD>(bf, Gt, np * 16, ks * 16, lane);
                mma(dpt[2 * np], va, bf[0], bf[1]);
                mma(dpt[2 * np + 1], va, bf[2], bf[3]);
            }
        }
        // p^T and ds^T, zero off the mask
        const bool unmasked = tile_unmasked(p, segmented, positioned, q0, k0);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const int lq = nt * 8 + 2 * t4 + (e & 1);
                float pe = 0.f, ds = 0.f;
                if (unmasked || attends(p, segmented, positioned, q0 + lq, key[r], sq[lq],
                                        sk[r], pq[lq], pk[r])) {
                    pe = __expf(st[nt][e] * p.sm_scale - lse[lq]);
                    ds = pe * (dpt[nt][e] - delta[lq]) * p.sm_scale;
                }
                st[nt][e] = pe;
                dpt[nt][e] = ds;
            }
        }
        // dv += bf16(p)^T . g and dk += bf16(ds)^T . q
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
            const uint32_t pa[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                                    pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                                    pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                                    pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
            const uint32_t da[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                                    pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                                    pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                                    pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
            for (int dp = 0; dp < DT / 2; ++dp) {
                uint32_t bf[4];
                load_b_cols<LD>(bf, Gt, kk * 16, dp * 16, lane);
                mma(dv[2 * dp], pa, bf[0], bf[1]);
                mma(dv[2 * dp + 1], pa, bf[2], bf[3]);
                load_b_cols<LD>(bf, Qt, kk * 16, dp * 16, lane);
                mma(dk[2 * dp], da, bf[0], bf[1]);
                mma(dk[2 * dp + 1], da, bf[2], bf[3]);
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        if (key[r] >= p.S) continue;
        const size_t off = (((size_t)b * p.S + key[r]) * p.Hkv + hk) * D + 2 * t4;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
            *reinterpret_cast<uint32_t*>(p.dk + off + dt * 8) = pack_bf16(dk[dt][2 * r], dk[dt][2 * r + 1]);
            *reinterpret_cast<uint32_t*>(p.dv + off + dt * 8) = pack_bf16(dv[dt][2 * r], dv[dt][2 * r + 1]);
        }
    }
}

// -- launch --------------------------------------------------------------

enum Kind { kFwd, kDq, kDkv };

template <int D>
cudaError_t launch(Kind kind, const Params& p, cudaStream_t stream) {
    void (*kernel)(Params);
    dim3 grid;
    size_t smem;
    if (kind == kFwd) {
        kernel = flash_fwd_kernel<D>;
        grid = dim3((p.T + BQ - 1) / BQ, p.B * p.H);
        smem = Fwd<D>::smem();
    } else if (kind == kDq) {
        kernel = flash_dq_kernel<D>;
        grid = dim3((p.T + BQ - 1) / BQ, p.B * p.H);
        smem = Dq<D>::smem();
    } else {
        kernel = flash_dkv_kernel<D>;
        grid = dim3((p.S + BK - 1) / BK, p.B * p.Hkv);
        smem = Dkv<D>::smem();
    }
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, THREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

int run(int device, Kind kind, const Params& p, int D, void* stream) {
    if (p.B <= 0 || p.T <= 0 || p.S <= 0 || p.Hkv <= 0 || p.H % p.Hkv != 0)
        return (int)cudaErrorInvalidValue;
    if ((p.seg_q == nullptr) != (p.seg_kv == nullptr) ||
        (p.pos_q == nullptr) != (p.pos_kv == nullptr))
        return (int)cudaErrorInvalidValue;
    // launch on the tensors' device, and leave the caller's current device
    // as it was
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 64: err = launch<64>(kind, p, st); break;
        case 96: err = launch<96>(kind, p, st); break;
        case 128: err = launch<128>(kind, p, st); break;
        default: err = cudaErrorInvalidValue;
    }
    if (prev != device) {
        const cudaError_t restore = cudaSetDevice(prev);
        if (err == cudaSuccess) err = restore;
    }
    return (int)err;
}

Params base(const void* q, const void* k, const void* v, const void* seg_q,
            const void* seg_kv, const void* pos_q, const void* pos_kv, int B, int T, int S,
            int H, int Hkv, int causal, float sm_scale) {
    Params p = {};
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.seg_q = static_cast<const int*>(seg_q);
    p.seg_kv = static_cast<const int*>(seg_kv);
    p.pos_q = static_cast<const int*>(pos_q);
    p.pos_kv = static_cast<const int*>(pos_kv);
    p.B = B; p.T = T; p.S = S; p.H = H; p.Hkv = Hkv;
    p.causal = causal;
    p.sm_scale = sm_scale;
    return p;
}

}  // namespace

extern "C" {

// out [B, T, H, D] bf16, lse [B, H, T] f32
int flash_attention_fwd_bf16(int device, const void* q, const void* k, const void* v,
                             const void* seg_q, const void* seg_kv, const void* pos_q,
                             const void* pos_kv, void* out, void* lse, int B, int T, int S,
                             int H, int Hkv, int D, int causal, float sm_scale, void* stream) {
    Params p = base(q, k, v, seg_q, seg_kv, pos_q, pos_kv, B, T, S, H, Hkv, causal, sm_scale);
    p.out = static_cast<bf16*>(out);
    p.lse_out = static_cast<float*>(lse);
    return run(device, kFwd, p, D, stream);
}

// g / dq [B, T, H, D] bf16; lse, delta [B, H, T] f32
int flash_attention_dq_bf16(int device, const void* q, const void* k, const void* v,
                            const void* seg_q, const void* seg_kv, const void* pos_q,
                            const void* pos_kv, const void* g, const void* lse,
                            const void* delta, void* dq, int B, int T, int S, int H, int Hkv,
                            int D, int causal, float sm_scale, void* stream) {
    Params p = base(q, k, v, seg_q, seg_kv, pos_q, pos_kv, B, T, S, H, Hkv, causal, sm_scale);
    p.g = static_cast<const bf16*>(g);
    p.lse_in = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.dq = static_cast<bf16*>(dq);
    return run(device, kDq, p, D, stream);
}

// dk / dv [B, S, Hkv, D] bf16
int flash_attention_dkv_bf16(int device, const void* q, const void* k, const void* v,
                             const void* seg_q, const void* seg_kv, const void* pos_q,
                             const void* pos_kv, const void* g, const void* lse,
                             const void* delta, void* dk, void* dv, int B, int T, int S,
                             int H, int Hkv, int D, int causal, float sm_scale, void* stream) {
    Params p = base(q, k, v, seg_q, seg_kv, pos_q, pos_kv, B, T, S, H, Hkv, causal, sm_scale);
    p.g = static_cast<const bf16*>(g);
    p.lse_in = static_cast<const float*>(lse);
    p.delta = static_cast<const float*>(delta);
    p.dk = static_cast<bf16*>(dk);
    p.dv = static_cast<bf16*>(dv);
    return run(device, kDkv, p, D, stream);
}

const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
