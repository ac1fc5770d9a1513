// Paged decode attention, hand-written for Hopper (sm_90a): one kernel
// template over the page element and the query's source.
//
//   paged_decode_attention_bf16  replaces the Pallas TPU kernel
//       accelerate_tpu/ops/flash_attention.py:589  _paged_decode_kernel
//       (launched by paged_decode_attention, :758): kernel #4;
//   paged_decode_attention_{int8,fp8}  replace :604  _paged_decode_kernel_quant
//       (the same over int8 / e4m3 pages): kernel #5.  Pages are codes with
//       one f32 amax per (kv head, page) in k_scales / v_scales [Hkv, P]; a
//       code stands for f32(code) * (amax / QMAX), QMAX 127 (int8) or 448
//       (e4m3);
//   fused_bgmv_paged_decode_bf16  replaces :988  _fused_bgmv_decode_kernel
//       (body :928, launched by fused_bgmv_paged_decode, :1123): kernel #8;
//   fused_bgmv_paged_decode_{int8,fp8}  replace :999
//       _fused_bgmv_decode_kernel_quant: kernel #9.  Decode with a per-slot
//       LoRA delta on the query, computed in the same launch.
// #4 / #5 run once per layer on every decode step of a serve: one query
// token per slot against the slot's paged K/V.  #8 / #9 are a public op
// that no engine calls (as in the JAX package).
//
// Semantics (those of _paged_decode_body, :615, and _fused_bgmv_decode_body):
//   * q / out [S, H, D] bf16, pages [Hkv, P, page, D], block_tables [S, n],
//     positions [S] int32; q head h reads kv head h / group;
//   * #8 / #9 attend with q = f32(q_base) + gate * rope(delta) in f32, never
//     rounded to bf16: delta = (x[s] . A[id]) . B[id] in f32 over the
//     columns of the slot's q heads, roped split-half with the f32 tables at
//     min(max(pos, 0), max_len - 1), gate = (id != 0); an id outside
//     [1, n_adapters) takes no delta (q = f32(q_base));
//   * the key at index i is live iff i <= pos (pages past the table's end
//     are not read: a position past it sees the whole table);
//   * softmax and p . v in f32, p never rounded; the result is acc / l, or
//     acc where l == 0: a slot whose position lies before 0 gives zeros.
//     A masked key of the TPU kernel scores -0.7 * FLT_MAX and adds exactly
//     0 to l and acc; here it is not visited at all, to the same effect.
//
// What bounds it on an H100: a decode step reads every live key's K and V
// row once for a GQA group of query rows per kv head, about 4 flops a byte
// of bf16 (8 of codes) against the card's 295: it is bound by the live
// rows' bytes over 3.35 TB/s (the 600m model's 16 slots at positions up to
// 2047 over pages of 64: 11,692 live rows in 191 pages, 0.0108 ms in
// bf16); #8 / #9 add each adapter's A and B (rank 16 at the 600m q_proj:
// 49 KB each), A read once per (slot, live chunk) and B's columns once per
// block, through L2.  The TPU grid
// walked a slot's pages in order; one block per (slot, kv head) doing the
// same leaves most SMs idle behind the longest slot's chain of pages.  So:
//   * Split the page loop over blocks (flash-decoding).  A work unit is
//     (chunk, kv head x row tile, slot), a chunk `span` pages of the block
//     table (span = 256 tokens / page, at least one page: ops/flash_attention.py
//     decode_split_plan).  The grid covers the most chunks a table holds; a
//     block past its slot's last live key has no keys.  A slot's split
//     depends only on its own position, the page size and the span, so its
//     output is bitwise the same whatever the other slots hold.  #8 / #9
//     take the same split as #4 / #5.
//   * Keep copies in flight.  A block walks its chunk in tiles of 64 tokens
//     whatever the page size; each token range of one page in a tile is
//     contiguous in [Hkv, P, page, D], so it comes in as one bulk
//     asynchronous copy (cp.async.bulk, issued by the lanes of warp 0),
//     completing on the stage's mbarrier.  Two stages: the next tile loads
//     while this one is reduced.  Only live rows are copied.  Shared memory
//     does not grow with the page size (pages of 128 at D 128 launch).
//   * #8 / #9: the LoRA prologue runs under the first copies, and h is
//     computed once per cluster.  Warp 0 issues the first two stages'
//     copies before the prologue.  The (kv head x row tile) blocks of one
//     (slot, chunk) form a thread-block cluster of up to 8 blocks (the
//     largest divisor of their count: ops/flash_attention.py
//     fused_decode_plan), so a cluster is live or dead as a whole.  Each
//     block takes its 1/cluster of d_in's rows of A[id] (lora_common.cuh
//     lora_h, 16-byte loads), the blocks read each other's partials through
//     distributed shared memory and add them in rank order, so h is bitwise
//     the same in every block of every chunk; a block leaves only after its
//     peers have read its partial.  Each block then forms its rows' delta
//     from B[id]: the group's q heads are contiguous columns of a rank row,
//     read in 16-byte loads (the first two ranks of each thread staged by
//     cp.async before h, as are q_base's rows and the rope row), the rank
//     split over up to 8 thread groups added in group order; ropes it and
//     writes the f32 query tile.  The rows of an id-0 slot read q_base as
//     #4 / #5 do.  (Clusters of a slot's chunk blocks, one per (slot, kv
//     head), measured slower on the card: a dead chunk's block must stay
//     for the cluster's h, and the cluster must be resident at once.)
//   * Use the threads.  Eight warps; each takes 8 keys of a tile and keeps
//     its own online softmax (m, l, acc) over its keys.  The block's q rows
//     (the GQA group, up to 8 a row tile; larger groups take several row
//     tiles) are read once into registers.  q . k runs on the tensor cores
//     (mma.sync m16n8k16, the q rows as A's rows 0..7, the warp's keys as
//     B's columns): decode does only about 4 flops a byte, but on the CUDA
//     cores the dot products, their cross-lane sums and the codes' widening
//     cost more issue slots than the copies leave (on the card, that form
//     took as long without its copies as with them).  bf16 pages go to a
//     bf16 mma; int8 and e4m3 codes are exact in f16 and go to an f16 mma,
//     q scaled by 2^-8 on the way (the score takes 2^8 back), so that q up
//     to 65504 * 2^8 (about 1.7e7) fits in f16.  The scaled q is exact for
//     |q| >= 2^-9; below, f16's subnormals round it, an absolute error of at
//     most 2^-17 per element of q.  p . v stays on the CUDA cores in f32
//     (p is never rounded): lanes own pairs of columns of D (at D 96 two
//     keys a step, 16 lanes each), p comes from the lanes holding the
//     score.
//   * #8 / #9 keep the f32 query on the tensor cores without rounding it
//     once: q_hi = bf16(q) and q_lo = bf16(q - q_hi) (f16 of q * 2^-8 for
//     codes) fill A's rows 0..7 and 8..15 of the same mma, so D's rows g
//     and g + 8 hold q_hi . k and q_lo . k and the score is their f32 sum:
//     no extra mma.  q_lo's fragments are read from shared memory in the
//     page loop, not kept in registers beside #4's (on the card, the
//     registers cost a block per SM).  Error bound per element of q: |q - q_hi - q_lo| <=
//     2^-16 |q| for bf16 pages (two roundings to 8 significant bits), and
//     <= max(2^-22 |q|, 2^-17) for codes (two roundings to 11 bits; f16's
//     subnormals below |q| = 2^-6); so the score's error from q is at most
//     sm_scale * sum_d |e_d| |k_d| beside the products' f32 sums, where one
//     rounding of q to bf16 gives up to 2^-8 |q| an element.  An id-0 slot's
//     q_lo is 0: its scores, and its output, are bitwise #4 / #5's on
//     q_base.
//   * Codes widen in pairs: for the mma, e4m3 by one packed conversion to
//     f16 per two codes (__nv_cvt_fp8x2_to_halfraw2) and int8 by byte
//     selects under 1024 in f16; for p . v, e4m3 through f16 to f32 and
//     int8 by byte selects under 2^23 in f32 (no int-to-float conversion).
//     The page's scales are taken out of the products: score = (q . code) *
//     (amax_k / QMAX) * sm_scale, and acc += (p * amax_v / QMAX) * code.
//   * Combine in the same launch, deterministically.  The eight warps'
//     states merge in warp order in shared memory.  A slot with one chunk
//     writes its output directly; otherwise each chunk writes its partial
//     (acc[D], m, l) in f32 to `work` [S, Hkv * row tiles, chunks, rows,
//     D + 2], then __threadfence and an atomicAdd on the (slot, kv head x
//     row tile) counter; the block that brings it to the slot's chunk count
//     merges the chunks in chunk order (eight chunks' partials loaded at
//     once), writes bf16 out and sets the counter back to 0.  The counters
//     (int32 [S, Hkv * row tiles], zero between launches) are the caller's:
//     two launches in flight at once must not share them, so the ops module
//     keeps one buffer per device, stream and size (#4 / #5 and #8 / #9 on
//     one stream share it: their launches run in order), and no launch pays
//     a memset.  No float atomics: repeated launches on the same operands
//     give bitwise-equal outputs.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (accelerate_tpu_torch/ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lora_common.cuh"
#include "wgmma.cuh"

namespace {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 8 * kWarps;                // kv tokens a stage holds: 8 a warp
constexpr int kStages = 2;
constexpr int kMaxSpan = 256;                    // most pages a chunk may hold
constexpr int kBarBytes = 128;                   // the stages' mbarriers, padded
constexpr int kMaxRank = 64;                     // #8 / #9: LoRA rank
constexpr int kMaxCluster = 8;                   // #8 / #9: blocks sharing h (portable)

template <typename T>
__device__ __forceinline__ uint32_t bits(T v) {
    return *reinterpret_cast<const uint32_t*>(&v);
}

// The page element.
//   kfrag(row, d): the B fragment of mma m16n8k16 for k-slots 2t, 2t + 1,
//     2t + 8, 2t + 9 of a lane whose K row is `row`, elements d .. d + 3
//     (see the kernel: slot 2t + e holds column d + e, slot 2t + 8 + e
//     column d + 2 + e), as the mma's input type;
//   qfrag(q, d): the matching A fragment of a q row (bf16 in global memory);
//   split(q, hi, lo): the same of four f32 q elements, as hi + lo (#8 / #9);
//   unit(row, u): elements 2u, 2u + 1 of a V row widened to f32 (codes not
//     yet scaled).
// bf16 pages go to a bf16 mma as they are; codes to an f16 mma (int8 and
// e4m3 codes are exact in f16), with q scaled by 2^-8 on the way (kQScale
// undoes it in the score), so that |q| up to about 1.7e7 fits in f16; the
// scaled q is exact for |q| >= 2^-9 and off by at most 2^-17 below.
struct Bf16Pages {
    static constexpr bool kQuant = false;
    static constexpr int kBytes = 2;
    static constexpr float kQScale = 1.f;
    __device__ static uint2 kfrag(const unsigned char* row, int d) {
        return *reinterpret_cast<const uint2*>(row + 2 * d);
    }
    __device__ static uint2 qfrag(const bf16* q, int d) {
        return *reinterpret_cast<const uint2*>(q + d);
    }
    __device__ static void split(float4 q, uint2& hi, uint2& lo) {
        const __nv_bfloat162 h0 = __floats2bfloat162_rn(q.x, q.y);
        const __nv_bfloat162 h1 = __floats2bfloat162_rn(q.z, q.w);
        const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
        hi = make_uint2(bits(h0), bits(h1));
        lo = make_uint2(bits(__floats2bfloat162_rn(__fsub_rn(q.x, f0.x), __fsub_rn(q.y, f0.y))),
                        bits(__floats2bfloat162_rn(__fsub_rn(q.z, f1.x), __fsub_rn(q.w, f1.y))));
    }
    __device__ static float2 unit(const unsigned char* row, int u) {
        return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(row)[u]);
    }
};

struct CodePages {
    static constexpr bool kQuant = true;
    static constexpr int kBytes = 1;
    static constexpr float kQScale = 256.f;
    __device__ static uint2 qfrag(const bf16* q, int d) {
        const float2 lo = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(q + d)[0]);
        const float2 hi = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(q + d)[1]);
        const __half2 a = __floats2half2_rn(lo.x * (1.f / kQScale), lo.y * (1.f / kQScale));
        const __half2 b = __floats2half2_rn(hi.x * (1.f / kQScale), hi.y * (1.f / kQScale));
        return make_uint2(bits(a), bits(b));
    }
    __device__ static void split(float4 q, uint2& hi, uint2& lo) {
        constexpr float s = 1.f / kQScale;       // exact: q * s is q's value
        const float4 v = make_float4(__fmul_rn(q.x, s), __fmul_rn(q.y, s), __fmul_rn(q.z, s),
                                     __fmul_rn(q.w, s));
        const __half2 h0 = __floats2half2_rn(v.x, v.y), h1 = __floats2half2_rn(v.z, v.w);
        const float2 f0 = __half22float2(h0), f1 = __half22float2(h1);
        hi = make_uint2(bits(h0), bits(h1));
        lo = make_uint2(bits(__floats2half2_rn(__fsub_rn(v.x, f0.x), __fsub_rn(v.y, f0.y))),
                        bits(__floats2half2_rn(__fsub_rn(v.z, f1.x), __fsub_rn(v.w, f1.y))));
    }
};

struct Int8Codes : CodePages {
    static constexpr float kQmax = 127.f;
    // code + 128 into the low mantissa byte of 1024 (f16) or 2^23 (f32):
    // exact, then less 1152 or 2^23 + 128 (no int-to-float conversion, a
    // quarter-rate op)
    __device__ static uint2 kfrag(const unsigned char* row, int d) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(row + d) ^ 0x80808080u;
        const uint32_t bias = 0x64806480u;                     // 1152 in both halves
        uint2 b;
        b.x = __byte_perm(w, 0x64646464u, 0x5140);
        b.y = __byte_perm(w, 0x64646464u, 0x5342);
        const __half2 lo = __hsub2(*reinterpret_cast<const __half2*>(&b.x),
                                   *reinterpret_cast<const __half2*>(&bias));
        const __half2 hi = __hsub2(*reinterpret_cast<const __half2*>(&b.y),
                                   *reinterpret_cast<const __half2*>(&bias));
        return make_uint2(bits(lo), bits(hi));
    }
    __device__ static float2 unit(const unsigned char* row, int u) {
        const uint32_t w = reinterpret_cast<const uint16_t*>(row)[u] ^ 0x8080u;
        return make_float2(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7440)) - 8388736.f,
                           __int_as_float(__byte_perm(w, 0x4B000000u, 0x7441)) - 8388736.f);
    }
};

struct Fp8Codes : CodePages {
    static constexpr float kQmax = 448.f;
    // one packed conversion per two codes; e4m3 -> f16 is exact
    __device__ static uint32_t half2_of(uint32_t pair) {
        const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)pair, __NV_E4M3);
        return bits(h);
    }
    __device__ static uint2 kfrag(const unsigned char* row, int d) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(row + d);
        return make_uint2(half2_of(w & 0xffffu), half2_of(w >> 16));
    }
    __device__ static float2 unit(const unsigned char* row, int u) {
        return __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
            reinterpret_cast<const __nv_fp8x2_storage_t*>(row)[u], __NV_E4M3)));
    }
};

struct Args {
    const bf16* q;                               // #8 / #9: q_base
    const unsigned char* k_pages;
    const unsigned char* v_pages;
    const float* k_scales;
    const float* v_scales;
    const int* block_tables;
    const int* positions;
    bf16* out;
    float* work;
    int* counters;
    int S, H, Hkv, P, page, n, span;
    float sm_scale;
    // #8 / #9's LoRA operands: x [S, d_in], a_stack [N, d_in, r], b_stack
    // [N, r, H * D] bf16, ids [S] int32, cos / sin [max_len, D / 2] f32
    const bf16* x;
    const bf16* a_stack;
    const bf16* b_stack;
    const int* ids;
    const float* cos;
    const float* sin;
    int d_in, r, n_adapters, max_len;
};

// `bytes` (a multiple of 16) from global memory to shared memory at dst,
// completing on the mbarrier at bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// d[16 x 8] += A[16 x 16] . B[16 x 8]: A's rows 0..7 `a` (the q rows),
// rows 8..15 `lo` (#8 / #9's q_lo rows; zero for #4 / #5)
template <typename Page>
__device__ __forceinline__ void mma_k16(float (&d)[4], uint2 a, uint2 lo, uint2 b) {
    if constexpr (Page::kQuant) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a.x), "r"(lo.x), "r"(a.y), "r"(lo.y), "r"(b.x), "r"(b.y));
    } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a.x), "r"(lo.x), "r"(a.y), "r"(lo.y), "r"(b.x), "r"(b.y));
    }
}

// #8 / #9's f32 query tile: rows of D + 16 floats, so the 16-byte reads of
// two rows by a quarter warp fall in disjoint banks at D 64, 96 and 128
template <int D>
__host__ __device__ constexpr int q_stride() {
    return D + 16;
}

// shared memory: the mbarriers, kStages (K, V) tiles, the warps' partials,
// the chunk's page ids (and two scales a page for codes) rounded to 16
// bytes, then #8 / #9's LoRA region: h's share (hp) and sum (hl), lora_h's
// per-warp sums (red), the query tile (qt), and the rope tables' row (cos,
// sin) and q_base's rows staged by cp.async, q_lo's fragments (qls)
template <int D, int ROWS>
constexpr size_t smem_lora() {
    return sizeof(float) * ((2 + kWarps) * kMaxRank + ROWS * q_stride<D>() + D) +
           sizeof(bf16) * ROWS * D + sizeof(uint2) * 32 * (D / 16);
}

template <typename Page, int D, int ROWS, bool LORA>
size_t smem_bytes(int span) {
    const size_t ids = (sizeof(int) * span * (Page::kQuant ? 3 : 1) + 15) / 16 * 16;
    return kBarBytes + (size_t)kStages * 2 * kTile * D * Page::kBytes +
           sizeof(float) * kWarps * ROWS * (D + 2) + ids + (LORA ? smem_lora<D, ROWS>() : 0);
}

// #8 / #9: this block's share of h = x[s] . A[id], rows rank * slice ..
// of d_in, into hp (every thread of the block calls it)
__device__ __forceinline__ void lora_h_share(const Args& a, float* hp, float* red, int s, int id,
                                             int tid) {
    const int ncta = (int)cluster_nctarank(), rank = (int)cluster_ctarank();
    const int slice = (a.d_in + ncta - 1) / ncta;
    const int lo = min(a.d_in, rank * slice), hi = min(a.d_in, lo + slice);
    lora_h<kThreads>(a.x + (size_t)s * a.d_in + lo, a.a_stack + ((size_t)id * a.d_in + lo) * a.r,
                     hi - lo, a.r, red, hp, tid);
}

__device__ __forceinline__ void fma8(float (&acc)[8], float h, uint4 v) {
    const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(v2[e]);
        acc[2 * e] = fmaf(h, f.x, acc[2 * e]);
        acc[2 * e + 1] = fmaf(h, f.y, acc[2 * e + 1]);
    }
}

// #8 / #9's prologue in a live block of an adapter slot: h from the
// cluster's shares (added in rank order), then the block's rows' delta
// from B[id] (dpart: the thread groups' partial sums), roped and added to
// q_base into the f32 tile qt.  The loads that do not wait on h (the
// thread's first rows of B into dpart, q_base's rows and the rope tables'
// row, all by cp.async into shared memory) go out before h's share.
// Arrives on the cluster barrier once it has read its peers' shares; the
// kernel waits on it before it leaves.
template <int D, int ROWS>
__device__ __forceinline__ void lora_query(const Args& a, float* hp, float* hl, float* red,
                                           float* dpart, float* qt, int s, int hq0, int nrows,
                                           int pos, int tid) {
    constexpr int QS = q_stride<D>();
    constexpr int HALF = D / 2;
    constexpr int KPRE = 2;                      // rows of B a thread stages before h
    const int id = a.ids[s];
    const int R = a.r;

    // delta[row][col] = sum_k h[k] . B[id][k][(hq0 + row) * D + col]: the
    // block's rows are nrows * D contiguous columns of every rank row;
    // thread (gi, j) takes 8 of them and the ranks k = gi mod G, its first
    // KPRE staged in dpart (4 * G * nrows * D bytes, within its size)
    const int nch = nrows * D / 8;
    const int G = min(8, kThreads / nch);
    const int j = tid % nch, gi = tid / nch;
    const size_t ld = (size_t)a.H * D;
    const bf16* bcol = a.b_stack + (size_t)id * R * ld + (size_t)hq0 * D + 8 * j;
    uint4* bstage = reinterpret_cast<uint4*>(dpart);
#pragma unroll
    for (int e = 0; e < KPRE; ++e)
        if (gi < G && gi + e * G < R)
            cp_async16(smem_u32(bstage + (e * G + gi) * nch + j), bcol + (size_t)(gi + e * G) * ld,
                       true);
    cp_async_commit();

    // the rope tables' row at the clamped position and q_base's rows, by
    // cp.async into shared memory while h is computed
    const int p = min(max(pos, 0), a.max_len - 1);
    float* rcos = qt + ROWS * QS;
    float* rsin = rcos + HALF;
    bf16* rqb = reinterpret_cast<bf16*>(rsin + HALF);
    {
        constexpr int NCS = HALF / 4;            // 16-byte copies of a table row
        const bf16* qb = a.q + ((size_t)s * a.H + hq0) * D;
        for (int i = tid; i < 2 * NCS + nrows * D / 8; i += kThreads) {
            if (i < NCS)
                cp_async16(smem_u32(rcos + 4 * i), a.cos + (size_t)p * HALF + 4 * i, true);
            else if (i < 2 * NCS)
                cp_async16(smem_u32(rsin + 4 * (i - NCS)), a.sin + (size_t)p * HALF + 4 * (i - NCS),
                           true);
            else
                cp_async16(smem_u32(rqb + 8 * (i - 2 * NCS)), qb + 8 * (i - 2 * NCS), true);
        }
        cp_async_commit();
    }


    lora_h_share(a, hp, red, s, id, tid);
    const int ncta = (int)cluster_nctarank();
    if (ncta > 1) {
        cluster_sync();                          // every block's share is written
        if (tid < R) {
            const uint32_t addr = smem_u32(hp + tid);
            float v[kMaxCluster];
#pragma unroll
            for (int q = 0; q < kMaxCluster; ++q) v[q] = q < ncta ? ld_cluster_f32(addr, q) : 0.f;
            float sum = v[0];
#pragma unroll
            for (int q = 1; q < kMaxCluster; ++q)
                if (q < ncta) sum += v[q];
            hl[tid] = sum;
        }
    } else if (tid < R) {
        hl[tid] = hp[tid];
    }
    cluster_arrive();                            // done with the peers' shares
    cp_async_wait<1>();                          // this thread's staged rows of B
    __syncthreads();

    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (gi < G) {
#pragma unroll
        for (int e = 0; e < KPRE; ++e)
            if (gi + e * G < R) fma8(acc, hl[gi + e * G], bstage[(e * G + gi) * nch + j]);
#pragma unroll 4
        for (int k = gi + KPRE * G; k < R; k += G)
            fma8(acc, hl[k], __ldg(reinterpret_cast<const uint4*>(bcol + (size_t)k * ld)));
    }
    __syncthreads();                             // the staged rows are read: dpart is free
    if (gi < G) {
        float4* dst = reinterpret_cast<float4*>(dpart + ((size_t)gi * nch + j) * 8);
        dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    __syncthreads();
    if (tid < nch) {                             // the groups' sums, in group order
        const float4* src = reinterpret_cast<const float4*>(dpart + (size_t)tid * 8);
        float4 u = src[0], w = src[1];
        for (int g2 = 1; g2 < G; ++g2) {
            const float4* q4 = reinterpret_cast<const float4*>(dpart + ((size_t)g2 * nch + tid) * 8);
            const float4 pu = q4[0], pw = q4[1];
            u = make_float4(u.x + pu.x, u.y + pu.y, u.z + pu.z, u.w + pu.w);
            w = make_float4(w.x + pw.x, w.y + pw.y, w.z + pw.z, w.w + pw.w);
        }
        float4* dst = reinterpret_cast<float4*>(qt + (8 * tid / D) * QS + 8 * tid % D);
        dst[0] = u;
        dst[1] = w;
    }
    cp_async_wait<0>();                          // this thread's staged tables and q_base
    __syncthreads();

    // q = f32(q_base) + rope(delta) split-half (gate 1: the slot's id is not
    // 0), each step rounded as the plain version rounds it
    for (int i = tid; i < nrows * HALF; i += kThreads) {
        const int row = i / HALF, c = i % HALF;
        const float d1 = qt[row * QS + c], d2 = qt[row * QS + c + HALF];
        const float e1 = __fsub_rn(__fmul_rn(d1, rcos[c]), __fmul_rn(d2, rsin[c]));
        const float e2 = __fadd_rn(__fmul_rn(d2, rcos[c]), __fmul_rn(d1, rsin[c]));
        qt[row * QS + c] = __fadd_rn(__bfloat162float(rqb[row * D + c]), e1);
        qt[row * QS + c + HALF] = __fadd_rn(__bfloat162float(rqb[row * D + c + HALF]), e2);
    }
    __syncthreads();
}

// One block: (chunk, kv head x row tile, slot).  Page: element type; D:
// head dim; ROWS: query rows a block holds (<= 8); LORA: #8 / #9's query
// (shared_h: this slot's id takes a delta, so the block takes part in the
// cluster's h).
template <typename Page, int D, int ROWS, bool LORA>
__device__ __forceinline__ void decode_block(const Args& a, const bool shared_h) {
    constexpr int ROWB = D * Page::kBytes;       // bytes of a K or V row
    constexpr int REC = D + 2;                   // a partial: acc[D], m, l
    constexpr int KSTEPS = D / 16;
    constexpr int QS = q_stride<D>();
    // p . v: lanes own pairs of columns (units); at D 96 a warp takes two
    // keys a step, 16 lanes each, three units a lane
    constexpr int UNITS = D / 2;
    constexpr int UPL = D == 96 ? 3 : UNITS / 32;            // units a lane
    constexpr int LPK = UNITS / UPL;                         // lanes a key
    constexpr int KPS = 32 / LPK;                            // keys a step
    static_assert(D % 32 == 0 && ROWS <= 8 && LPK * KPS == 32, "unsupported tile");

    const int c = blockIdx.x;
    const int y = blockIdx.y;
    const int s = blockIdx.z;
    const int group = a.H / a.Hkv;
    const int row_tiles = (group + ROWS - 1) / ROWS;
    const int h = y / row_tiles;
    const int r0 = (y % row_tiles) * ROWS;
    const int nrows = min(ROWS, group - r0);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;       // the mma fragments' row / column group

    // the slot's live keys and chunks: its own position only
    const int pos = a.positions[s];
    const int chunk_tokens = a.span * a.page;
    const int live = pos < 0 ? 0 : min(pos + 1, a.n * a.page);
    const int chunks = (live + chunk_tokens - 1) / chunk_tokens;
    bf16* out = a.out + ((size_t)s * a.H + (size_t)h * group + r0) * D;
    if (chunks == 0) {                           // acc / l with l == 0: zeros
        if (c == 0)
            for (int i = tid; i < nrows * D; i += kThreads) out[i] = __float2bfloat16(0.f);
        return;
    }

    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    unsigned char* kv = smem + kBarBytes;                      // per stage: K tile, V tile
    float* wsum = reinterpret_cast<float*>(kv + kStages * 2 * kTile * ROWB);
    int* pid_s = reinterpret_cast<int*>(wsum + kWarps * ROWS * REC);
    float* ks_s = reinterpret_cast<float*>(pid_s + a.span);  // codes: amax / QMAX a page
    float* vs_s = ks_s + a.span;
    float* hp = reinterpret_cast<float*>(
        reinterpret_cast<unsigned char*>(pid_s) +
        (sizeof(int) * a.span * (Page::kQuant ? 3 : 1) + 15) / 16 * 16);
    float* hl = hp + kMaxRank;
    float* red = hl + kMaxRank;
    float* qt = red + kWarps * kMaxRank;
    uint2* qls = reinterpret_cast<uint2*>(qt + ROWS * QS + D) + ROWS * D / 4;   // after rqb
    __shared__ int last;

    if (c >= chunks) return;                     // no live key in this chunk

    const int ctok = min(chunk_tokens, live - c * chunk_tokens);   // live keys of the chunk
    const int npages = (ctok + a.page - 1) / a.page;
    const int ntiles = (ctok + kTile - 1) / kTile;
    const int* table = a.block_tables + (size_t)s * a.n + (size_t)c * a.span;
    const size_t head = (size_t)h * a.P;
    // the last tile's V rows past the chunk's live keys start as zeros: p . v
    // reads all 8 rows of a warp's keys and weighs those by p = 0, so they
    // must be finite (an earlier tile in the same stage leaves finite rows)
    if (const int tail = ctok - (ntiles - 1) * kTile; tail < kTile) {
        unsigned char* vlast = kv + ((ntiles - 1) % kStages * 2 + 1) * kTile * ROWB;
        for (int i = tail * ROWB / 16 + tid; i < kTile * ROWB / 16; i += kThreads)
            reinterpret_cast<uint4*>(vlast)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_async_shared();
    if (tid == 0) {
        for (int st = 0; st < kStages; ++st) mbar_init(smem_u32(full + st), 1);
        mbar_init_fence();
    }
    __syncthreads();

    // warp 0: tile t's live rows into stage t % kStages, one bulk copy per
    // page it touches for K and one for V (page ids from the table for the
    // first stages, so the first copies wait on no other warp, and go out
    // before #8 / #9's prologue)
    auto issue = [&](int t, const int* pids) {
        const int st = t % kStages;
        const int lo_tok = t * kTile, hi_tok = min(lo_tok + kTile, ctok);
        const uint32_t bar = smem_u32(full + st);
        if (lane == 0) mbar_arrive_expect_tx(bar, 2u * (hi_tok - lo_tok) * ROWB);
        __syncwarp();
        unsigned char* kdst = kv + st * 2 * kTile * ROWB;
        unsigned char* vdst = kdst + kTile * ROWB;
        for (int p = lo_tok / a.page + lane; p <= (hi_tok - 1) / a.page; p += 32) {
            const int lo = max(lo_tok, p * a.page), hi = min(hi_tok, (p + 1) * a.page);
            const size_t src = ((head + pids[p]) * a.page + (lo - p * a.page)) * (size_t)ROWB;
            const uint32_t bytes = (hi - lo) * ROWB;
            bulk_load(smem_u32(kdst + (lo - lo_tok) * ROWB), a.k_pages + src, bytes, bar);
            bulk_load(smem_u32(vdst + (lo - lo_tok) * ROWB), a.v_pages + src, bytes, bar);
        }
    };
    if (warp == 0)
        for (int t = 0; t < min(kStages, ntiles); ++t) issue(t, table);

    // the chunk's page ids (and each page's two scales), read once for the
    // later tiles' copies and the codes' scales
    for (int i = tid; i < npages; i += kThreads) {
        const int pid = table[i];
        pid_s[i] = pid;
        if constexpr (Page::kQuant) {
            ks_s[i] = a.k_scales[head + pid] / Page::kQmax;
            vs_s[i] = a.v_scales[head + pid] / Page::kQmax;
        }
    }

    // q . k on the tensor cores: the block's query rows are the A operand's
    // rows 0..7 (rows past nrows zero), #8 / #9's q_lo rows 8..15 (else
    // zero), the warp's 8 keys of a tile its columns.  Lane (g, t4) gives
    // k-slots 2t4, 2t4 + 1, 2t4 + 8, 2t4 + 9 of every k-step the four columns
    // d + 4t4 .. d + 4t4 + 3, in A and in B alike, so each lane reads 8
    // contiguous bytes of a K row (4 of codes).
    // #8 / #9 keep q_lo's fragments (the same in every warp) in shared
    // memory, one per (k-step, lane), beside the page loop's registers
    uint2 qa[KSTEPS];
    bool from_tile = false;
    if constexpr (LORA) {
        if (shared_h) {
            lora_query<D, ROWS>(a, hp, hl, red, wsum, qt, s, h * group + r0, nrows, pos, tid);
            from_tile = true;
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks) {
                uint2 lo = make_uint2(0u, 0u);
                qa[ks] = make_uint2(0u, 0u);
                if (g < nrows)
                    Page::split(*reinterpret_cast<const float4*>(qt + g * QS + 16 * ks + 4 * t4),
                                qa[ks], lo);
                if (warp == 0) qls[ks * 32 + lane] = lo;
            }
        } else if (warp == 0) {
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ++ks) qls[ks * 32 + lane] = make_uint2(0u, 0u);
        }
    }
    if (!from_tile) {
        const bf16* qrow = a.q + ((size_t)s * a.H + (size_t)h * group + r0 + min(g, nrows - 1)) * D;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
            qa[ks] = g < nrows ? Page::qfrag(qrow, 16 * ks + 4 * t4) : make_uint2(0u, 0u);
    }

    // lane (g, t4): row g's running max and the p of its two keys a tile;
    // acc: the lane's columns of every row
    float m_row = -INFINITY, l_row = 0.f;
    float2 acc[ROWS][UPL];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int j = 0; j < UPL; ++j) acc[r][j] = make_float2(0.f, 0.f);
    const int k0 = warp * 8;                     // the warp's keys in a tile
    const float inv_page = 1.f / (float)a.page;
    __syncthreads();                             // the staged ids and scales
    const int half = lane / LPK, ul = lane % LPK;

    for (int t = 0; t < ntiles; ++t) {
        const int st = t % kStages;
        mbar_wait(smem_u32(full + st), (t / kStages) & 1);
        const unsigned char* ktile = kv + st * 2 * kTile * ROWB;
        const unsigned char* vtile = ktile + kTile * ROWB;
        const int tlen = min(kTile, ctok - t * kTile);

        // scores of row g, keys k0 + 2t4 and k0 + 2t4 + 1 (every warp runs
        // straight-line; keys past the tile's live ones score -inf); #8 /
        // #9 add the q_lo rows' products (D's rows g + 8)
        float raw0, raw1;
        {
            // even and odd k-steps on two accumulators: two chains of mmas
            float sc[4] = {0.f, 0.f, 0.f, 0.f}, odd[4] = {0.f, 0.f, 0.f, 0.f};
            const unsigned char* krow = ktile + (k0 + g) * ROWB;
#pragma unroll
            for (int ks = 0; ks < KSTEPS; ks += 2) {
                uint2 lo0 = make_uint2(0u, 0u), lo1 = lo0;
                if constexpr (LORA) {
                    lo0 = qls[ks * 32 + lane];
                    lo1 = qls[(ks + 1) * 32 + lane];
                }
                mma_k16<Page>(sc, qa[ks], lo0, Page::kfrag(krow, 16 * ks + 4 * t4));
                mma_k16<Page>(odd, qa[ks + 1], lo1, Page::kfrag(krow, 16 * ks + 16 + 4 * t4));
            }
            raw0 = sc[0] + odd[0];
            raw1 = sc[1] + odd[1];
            if constexpr (LORA) {
                raw0 += sc[2] + odd[2];
                raw1 += sc[3] + odd[3];
            }
        }
        const int key0 = k0 + 2 * t4;
        float ksc0 = a.sm_scale * Page::kQScale, ksc1 = ksc0, vsc0 = 1.f, vsc1 = 1.f;
        if constexpr (Page::kQuant) {
            // the keys' pages: (token + 0.5) * (1 / page) in f32 floors
            // exactly for the few hundred tokens of a chunk, pages below
            // 2^15 tokens
            const float tok = (float)(t * kTile + key0) + 0.5f;
            const int p0 = min((int)(tok * inv_page), npages - 1);
            const int p1 = min((int)((tok + 1.f) * inv_page), npages - 1);
            ksc0 *= ks_s[p0];
            ksc1 *= ks_s[p1];
            vsc0 = vs_s[p0];
            vsc1 = vs_s[p1];
        }
        const float s0 = key0 < tlen ? raw0 * ksc0 : -INFINITY;
        const float s1 = key0 + 1 < tlen ? raw1 * ksc1 : -INFINITY;
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_row, mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;   // no live key yet
        const float alpha = expf(m_row - m_use);
        const float p0 = expf(s0 - m_use), p1 = expf(s1 - m_use);
        l_row = fmaf(l_row, alpha, p0) + p1;
        m_row = m_new;
        const float pv0 = p0 * vsc0, pv1 = p1 * vsc1;

        // acc = acc * alpha + p . v, in f32 (row r's alpha and p from the
        // lanes of group r)
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const float ar = __shfl_sync(0xffffffffu, alpha, 4 * r);
#pragma unroll
            for (int j = 0; j < UPL; ++j) {
                acc[r][j].x *= ar;
                acc[r][j].y *= ar;
            }
        }
#pragma unroll
        for (int k = 0; k < 8; k += KPS) {
            const int key = k + half;
            const unsigned char* vrow = vtile + (k0 + key) * ROWB;
            float pk[ROWS];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const int src = 4 * r + k / 2;
                if constexpr (KPS == 1) {
                    pk[r] = __shfl_sync(0xffffffffu, (k & 1) ? pv1 : pv0, src);
                } else {                         // keys k (even) and k + 1
                    const float e = __shfl_sync(0xffffffffu, pv0, src);
                    const float o = __shfl_sync(0xffffffffu, pv1, src);
                    pk[r] = half ? o : e;
                }
            }
#pragma unroll
            for (int j = 0; j < UPL; ++j) {
                const float2 vv = Page::unit(vrow, ul + LPK * j);
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    acc[r][j].x = fmaf(pk[r], vv.x, acc[r][j].x);
                    acc[r][j].y = fmaf(pk[r], vv.y, acc[r][j].y);
                }
            }
        }
        __syncthreads();                         // every warp is done with stage st
        if (warp == 0 && t + kStages < ntiles) issue(t + kStages, pid_s);
    }

    // each warp's (acc, m, l) into shared memory, then merged in warp order
    float* wp = wsum + warp * ROWS * REC;
    l_row += __shfl_xor_sync(0xffffffffu, l_row, 1);
    l_row += __shfl_xor_sync(0xffffffffu, l_row, 2);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int j = 0; j < UPL; ++j) {
            float2 v = acc[r][j];
            if constexpr (KPS == 2) {            // the two halves' keys
                v.x += __shfl_xor_sync(0xffffffffu, v.x, 16);
                v.y += __shfl_xor_sync(0xffffffffu, v.y, 16);
            }
            if (half == 0) {
                const int u = ul + LPK * j;
                wp[r * REC + 2 * u] = v.x;
                wp[r * REC + 2 * u + 1] = v.y;
            }
        }
    }
    if (t4 == 0 && g < ROWS) {
        wp[g * REC + D] = m_row;
        wp[g * REC + D + 1] = l_row;
    }
    __syncthreads();

    // this (slot, kv head x row tile)'s chunk 0 record in the workspace
    const int table_chunks = (a.n + a.span - 1) / a.span;
    const size_t first = (((size_t)s * gridDim.y + y) * table_chunks) * ROWS * REC;
    for (int i = tid; i < nrows * D; i += kThreads) {
        const int r = i / D, d = i % D;
        float M = -INFINITY;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wsum[(w * ROWS + r) * REC + D]);
        float A = 0.f, L = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float* rec = wsum + (w * ROWS + r) * REC;
            const float e = expf(rec[D] - M);                // 0 for a warp with no key
            A = fmaf(e, rec[d], A);
            L = fmaf(e, rec[D + 1], L);
        }
        if (chunks == 1) {
            out[i] = __float2bfloat16(A / L);
        } else {
            float* rec = a.work + first + ((size_t)c * ROWS + r) * REC;
            rec[d] = A;
            if (d == 0) *reinterpret_cast<float2*>(rec + D) = make_float2(M, L);
        }
    }
    if (chunks == 1) return;

    // the last chunk of the (slot, kv head x row tile) to finish merges all
    // of them, in chunk order
    __threadfence();
    __syncthreads();
    int* counter = a.counters + (size_t)s * gridDim.y + y;
    if (tid == 0) last = atomicAdd(counter, 1) == chunks - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const float* work = a.work + first;
    constexpr int kBatch = 8;                    // chunks whose loads are in flight together
    for (int i = tid; i < nrows * D; i += kThreads) {
        const int r = i / D, d = i % D;
        float M = -INFINITY, A = 0.f, L = 0.f;
        for (int c0 = 0; c0 < chunks; c0 += kBatch) {
            float2 ml[kBatch];
            float v[kBatch];
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                const float* rec = work + ((size_t)min(c0 + k, chunks - 1) * ROWS + r) * REC;
                ml[k] = __ldcg(reinterpret_cast<const float2*>(rec + D));
                v[k] = __ldcg(rec + d);
            }
            float M2 = M;
#pragma unroll
            for (int k = 0; k < kBatch; ++k)
                if (c0 + k < chunks) M2 = fmaxf(M2, ml[k].x);
            const float scale = expf(M - M2);    // 0 on the first batch
            A *= scale;
            L *= scale;
#pragma unroll
            for (int k = 0; k < kBatch; ++k) {
                if (c0 + k < chunks) {
                    const float e = expf(ml[k].x - M2);
                    A = fmaf(e, v[k], A);
                    L = fmaf(e, ml[k].y, L);
                }
            }
            M = M2;
        }
        out[i] = __float2bfloat16(A / L);
    }
    if (tid == 0) atomicExch(counter, 0);
}

template <typename Page, int D, int ROWS, bool LORA>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Args a) {
    // #8 / #9: a live chunk of an adapter slot (the same for the whole
    // cluster: its blocks share the slot and the chunk) shares h
    bool shared_h = false;
    if constexpr (LORA) {
        const int id = a.ids[blockIdx.z], pos = a.positions[blockIdx.z];
        const int live = pos < 0 ? 0 : min(pos + 1, a.n * a.page);
        shared_h = id > 0 && id < a.n_adapters && (int)blockIdx.x * a.span * a.page < live;
    }
    decode_block<Page, D, ROWS, LORA>(a, shared_h);
    if constexpr (LORA) {
        if (shared_h) cluster_wait();            // the peers have read this block's share
    }
}

template <typename Page, int D, int ROWS, bool LORA>
cudaError_t launch(const Args& a, int cluster, cudaStream_t stream) {
    const size_t smem = smem_bytes<Page, D, ROWS, LORA>(a.span);
    auto kernel = paged_decode_kernel<Page, D, ROWS, LORA>;
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
    const int group = a.H / a.Hkv;
    const int chunks = (a.n + a.span - 1) / a.span;
    const dim3 grid(chunks, a.Hkv * ((group + ROWS - 1) / ROWS), a.S);
    if (grid.y > 65535 || grid.z > 65535 || grid.y % cluster) return cudaErrorInvalidConfiguration;
    if constexpr (!LORA) {
        kernel<<<grid, kThreads, smem, stream>>>(a);
    } else {
        // #8 / #9: the (kv head x row tile) blocks of a (slot, chunk),
        // `cluster` at a time, form a cluster
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = grid;
        cfg.blockDim = dim3(kThreads);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = stream;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = 1;
        attr[0].val.clusterDim.y = cluster;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        err = cudaLaunchKernelEx(&cfg, kernel, a);
        if (err != cudaSuccess) return err;
    }
    return cudaGetLastError();
}

template <typename Page, int D, bool LORA>
cudaError_t launch_rows(const Args& a, int rows, int cluster, cudaStream_t stream) {
    switch (rows) {
        case 2: return launch<Page, D, 2, LORA>(a, cluster, stream);
        case 4: return launch<Page, D, 4, LORA>(a, cluster, stream);
        case 8: return launch<Page, D, 8, LORA>(a, cluster, stream);
        default: return cudaErrorInvalidValue;
    }
}

// Checks the plan and launches on the tensors' device, leaving the
// caller's current device as it was.
template <typename Page, bool LORA>
int dispatch(int device, Args& a, int D, int rows, int cluster, void* stream) {
    if (a.S <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.P <= 0 || a.page <= 0 || a.n <= 0 ||
        a.span < 1 || a.span > kMaxSpan)
        return (int)cudaErrorInvalidValue;
    if (Page::kQuant && (a.k_scales == nullptr || a.v_scales == nullptr))
        return (int)cudaErrorInvalidValue;
    if (a.n > a.span && (a.work == nullptr || a.counters == nullptr))   // a slot may take two chunks
        return (int)cudaErrorInvalidValue;
    if (LORA && (a.r < 1 || a.r > kMaxRank || a.d_in <= 0 || a.n_adapters <= 0 ||
                 a.max_len <= 0 || cluster < 1 || cluster > kMaxCluster))
        return (int)cudaErrorInvalidValue;
    if (!LORA && cluster != 1) return (int)cudaErrorInvalidValue;
    int prev = 0;
    cudaError_t err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (D) {
        case 64: err = launch_rows<Page, 64, LORA>(a, rows, cluster, st); break;
        case 96: err = launch_rows<Page, 96, LORA>(a, rows, cluster, st); break;
        case 128: err = launch_rows<Page, 128, LORA>(a, rows, cluster, st); break;
        default: err = cudaErrorInvalidValue;
    }
    if (prev != device) {
        const cudaError_t restore = cudaSetDevice(prev);
        if (err == cudaSuccess) err = restore;
    }
    return (int)err;
}

Args decode_args(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
                 const void* v_scales, const void* block_tables, const void* positions, void* out,
                 void* work, void* counters, int S, int H, int Hkv, int P, int page, int n,
                 int span, float sm_scale) {
    Args a = {};
    a.q = static_cast<const bf16*>(q);
    a.k_pages = static_cast<const unsigned char*>(k_pages);
    a.v_pages = static_cast<const unsigned char*>(v_pages);
    a.k_scales = static_cast<const float*>(k_scales);
    a.v_scales = static_cast<const float*>(v_scales);
    a.block_tables = static_cast<const int*>(block_tables);
    a.positions = static_cast<const int*>(positions);
    a.out = static_cast<bf16*>(out);
    a.work = static_cast<float*>(work);
    a.counters = static_cast<int*>(counters);
    a.S = S, a.H = H, a.Hkv = Hkv, a.P = P, a.page = page, a.n = n, a.span = span;
    a.sm_scale = sm_scale;
    return a;
}

template <typename Page>
int decode(int device, const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales, const void* block_tables,
           const void* positions, void* out, void* work, void* counters, int S, int H, int Hkv,
           int D, int P, int page, int n, int span, int rows, float sm_scale, void* stream) {
    Args a = decode_args(q, k_pages, v_pages, k_scales, v_scales, block_tables, positions, out,
                         work, counters, S, H, Hkv, P, page, n, span, sm_scale);
    return dispatch<Page, false>(device, a, D, rows, 1, stream);
}

template <typename Page>
int fused(int device, const void* q_base, const void* x, const void* a_stack,
          const void* b_stack, const void* ids, const void* cos, const void* sin,
          const void* k_pages, const void* v_pages, const void* k_scales, const void* v_scales,
          const void* block_tables, const void* positions, void* out, void* work, void* counters,
          int S, int H, int Hkv, int D, int P, int page, int n, int span, int rows, int cluster,
          int d_in, int r, int n_adapters, int max_len, float sm_scale, void* stream) {
    Args a = decode_args(q_base, k_pages, v_pages, k_scales, v_scales, block_tables, positions,
                         out, work, counters, S, H, Hkv, P, page, n, span, sm_scale);
    a.x = static_cast<const bf16*>(x);
    a.a_stack = static_cast<const bf16*>(a_stack);
    a.b_stack = static_cast<const bf16*>(b_stack);
    a.ids = static_cast<const int*>(ids);
    a.cos = static_cast<const float*>(cos);
    a.sin = static_cast<const float*>(sin);
    a.d_in = d_in, a.r = r, a.n_adapters = n_adapters, a.max_len = max_len;
    return dispatch<Page, true>(device, a, D, rows, cluster, stream);
}

}  // namespace

extern "C" {

// #4: q / out [S, H, D] bf16, k_pages / v_pages [Hkv, P, page, D] bf16,
// block_tables [S, n] and positions [S] int32; work f32 [S, Hkv * row tiles,
// ceil(n / span), rows, D + 2] and counters int32 [S, Hkv * row tiles], zero
// (both may be NULL when n <= span); span pages a chunk, rows query rows a
// block (2, 4 or 8), as decode_split_plan gives them.
int paged_decode_attention_bf16(int device, const void* q, const void* k_pages,
                                const void* v_pages, const void* block_tables,
                                const void* positions, void* out, void* work, void* counters,
                                int S, int H, int Hkv, int D, int P, int page, int n, int span,
                                int rows, float sm_scale, void* stream) {
    return decode<Bf16Pages>(device, q, k_pages, v_pages, nullptr, nullptr, block_tables,
                             positions, out, work, counters, S, H, Hkv, D, P, page, n, span, rows,
                             sm_scale, stream);
}

// #5: as above with k_pages / v_pages int8 or e4m3 codes and k_scales /
// v_scales [Hkv, P] f32, each page's running amax.
int paged_decode_attention_int8(int device, const void* q, const void* k_pages,
                                const void* v_pages, const void* k_scales, const void* v_scales,
                                const void* block_tables, const void* positions, void* out,
                                void* work, void* counters, int S, int H, int Hkv, int D, int P,
                                int page, int n, int span, int rows, float sm_scale,
                                void* stream) {
    return decode<Int8Codes>(device, q, k_pages, v_pages, k_scales, v_scales, block_tables,
                             positions, out, work, counters, S, H, Hkv, D, P, page, n, span, rows,
                             sm_scale, stream);
}

int paged_decode_attention_fp8(int device, const void* q, const void* k_pages,
                               const void* v_pages, const void* k_scales, const void* v_scales,
                               const void* block_tables, const void* positions, void* out,
                               void* work, void* counters, int S, int H, int Hkv, int D, int P,
                               int page, int n, int span, int rows, float sm_scale,
                               void* stream) {
    return decode<Fp8Codes>(device, q, k_pages, v_pages, k_scales, v_scales, block_tables,
                            positions, out, work, counters, S, H, Hkv, D, P, page, n, span, rows,
                            sm_scale, stream);
}

// #8 / #9: q_base / out [S, H, D] bf16 (q_base already roped), x [S, d_in],
// a_stack [N, d_in, r], b_stack [N, r, H * D] bf16, ids [S] int32, cos / sin
// [max_len, D / 2] f32, the pages, tables, positions, work and counters as
// #4 / #5 take them (k_scales / v_scales NULL for bf16 pages); span and
// rows as decode_split_plan gives them, cluster (1 .. 8, at most the
// table's chunks) as fused_decode_plan gives it; r <= 64.
#define FUSED_ENTRY(name, Page)                                                               \
    int name(int device, const void* q_base, const void* x, const void* a_stack,             \
             const void* b_stack, const void* ids, const void* cos, const void* sin,          \
             const void* k_pages, const void* v_pages, const void* k_scales,                  \
             const void* v_scales, const void* block_tables, const void* positions,           \
             void* out, void* work, void* counters, int S, int H, int Hkv, int D, int P,      \
             int page, int n, int span, int rows, int cluster, int d_in, int r,               \
             int n_adapters, int max_len, float sm_scale, void* stream) {                     \
        return fused<Page>(device, q_base, x, a_stack, b_stack, ids, cos, sin, k_pages,       \
                           v_pages, k_scales, v_scales, block_tables, positions, out, work,   \
                           counters, S, H, Hkv, D, P, page, n, span, rows, cluster, d_in, r,  \
                           n_adapters, max_len, sm_scale, stream);                            \
    }

FUSED_ENTRY(fused_bgmv_paged_decode_bf16, Bf16Pages)
FUSED_ENTRY(fused_bgmv_paged_decode_int8, Int8Codes)
FUSED_ENTRY(fused_bgmv_paged_decode_fp8, Fp8Codes)
#undef FUSED_ENTRY

const char* paged_decode_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
