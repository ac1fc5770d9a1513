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
// Each has an f16 instance (flash_attention_{fwd,dq,dkv}_f16, the Pallas
// kernels' other float dtype): every kernel and launcher is a template over
// F16, which picks the products' operand type (wgmma .f16 / .bf16), the
// TMA maps' element type and the rounding of p, ds and the outputs; the
// bf16 instances are the code they were.
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
// Forward (#1), designed for Hopper: one block of three warpgroups per
// (128 query rows, batch * q head).
//   * A producer warpgroup gives up its registers (setmaxnreg) and one of
//     its threads issues TMA loads (cp.async.bulk.tensor) under mbarriers:
//     the block's Q tile once, then each 128-key K and V tile into a ring of
//     three shared-memory stages, from 4-D tensor maps (D, heads, sequence,
//     batch) in 64-column boxes with the 128-byte swizzle.  The maps read
//     q / k / v in place; a box's columns past D (D 96's second box) and its
//     rows past the batch's T or S arrive as zeros.  K and V of a stage
//     complete on barriers of their own, so S = Q K^T starts before V lands,
//     and are released on barriers of their own (one arrival per consumer
//     warp, after its wgmma wait), so the next K load starts while P V still
//     reads this stage's V.
//   * Two consumer warpgroups own 64 query rows each.  S = Q K^T is wgmma
//     m64n128k16 with both operands in shared memory (Q and K K-major);
//     scores are kept in base-2 units (sm_scale * log2(e) multiplies S),
//     the online softmax stays in registers, p is rounded once to bf16 and
//     is the register A operand of P V, V the MN-major B operand, in 64- and
//     32-wide wgmmas per 64-column chunk of D.  A tile wholly inside the
//     mask takes a branch of its own, uniform over the warpgroup; the others
//     (the diagonal, the ragged edge, segments, positions) mask by selects,
//     with no branch per element.
//   * Blocks run heaviest causal tiles first within groups of 8 (batch,
//     head) pairs, whose K and V then stay in L2 together.
//   * Departures from exact f32 besides f32 sums: p in bf16 (the Pallas
//     kernel's too) and the exponential, ex2.approx.ftz.f32 (about 2 ulp,
//     subnormals flushed to zero).  A row whose every score is masked keeps
//     m = DEFAULT_MASK_VALUE in natural units for its lse.
// Backward (#2, #3), designed for Hopper as the forward is: blocks of two
// consumer warpgroups of 64 rows (256 threads), whose thread 0 also issues
// the TMA loads, under mbarriers, from 4-D tensor maps in 64-column boxes
// with the 128-byte swizzle (columns past D and rows past T or S arrive as
// zeros); every product is a wgmma, and there is no online softmax (p comes
// from lse), so a tile's element work is one exponential and a few FMAs a
// pair.
//   * dq (#2): one block per (128 query rows, batch * q head).  Q and dO
//     land once; K and V tiles of 128 keys (64 at D 128) stream through a
//     ring of two stages (four at D 128), K and V on barriers of their own,
//     each tile loaded while the one before it is computed.  Per key tile a
//     consumer warpgroup issues S = Q K^T, then dP = dO V^T (wgmma m64n128k16,
//     m64n64k16 at D 128, both operands in shared memory, K-major), turns S
//     into p while dP runs, forms ds and rounds it to bf16 as the register A
//     operand of dQ += dS K (one m64nDk16 a 16 keys: K the MN-major B
//     operand, its two 64-column chunks a leading-byte offset apart), then
//     releases the stage.  Registers a consumer thread at D 96: S and dP
//     64 + 64, dQ 48, the dS operand 32: 208 before addresses.
//   * dk / dv (#3): one block per (128 keys, batch * kv head), each consumer
//     warpgroup owning 64 of them with K and V resident.  The block walks
//     every (GQA group member, query tile) pair itself, keeping the group
//     sum in registers: no atomics, and two runs give bitwise-equal
//     gradients.  Each query tile's Q and dO stream through a ring of four
//     stages on barriers of their own, two tiles ahead.  Its lse and delta
//     pass through a double buffer of each warpgroup's in shared memory,
//     loaded from L2 a tile ahead of their use (a TMA box of them would
//     start at an element that is not 16-byte aligned whenever T is odd);
//     segment ids and positions, off the unmasked fast path, come from L2.
//     Per tile: S^T = K Q^T and dP^T = V dO^T (wgmma m64nBQk16, shared-memory
//     operands, K-major); p^T = exp(S^T - lse) with lse broadcast along the
//     columns; dV += bf16(P^T) dO and dK += bf16(dS^T) Q with the register A
//     operand and dO / Q as MN-major B, left running under the next tile's
//     S^T and dP^T (every wait of the loop has a fixed group count, so ptxas
//     keeps the pipeline).  Registers a consumer thread at D 96 with 64-query
//     tiles: dK + dV 48 + 48, S^T and dP^T 32 + 32, the two A operands of the
//     products in flight 16 + 16: 192 before addresses.  At D 128 dK + dV
//     take 128, so the query tile is 32.
//   * Why 256 threads: ptxas compiles every warp of a kernel for the
//     registers of its launch bounds, and one spill or one move that
//     defines a wgmma operand inside a pipeline stage makes it serialise
//     every wgmma of the function (info C7512 / C7513).  The register file
//     is split between the SM's four sub-partitions: 384 threads (the
//     forward's producer warpgroup) or 288 (a producer warp) put three warps
//     on one of them, and ptxas allows 168 registers a thread whatever
//     setmaxnreg grants at run time; 256 threads allow 255.  So a consumer
//     thread issues the loads, at the start of each tile, into the stage of
//     a tile the other warpgroup has most likely released by then.
//   * A warpgroup with nothing in a tile (past the causal diagonal, or rows
//     past T / keys past S) waits for the tile's loads and releases it
//     without computing, so each stage's release still counts both
//     warpgroups.
//   * Blocks run heaviest causal tiles first (dq: the last query tiles, dkv:
//     the first key tiles) within groups of 8 (batch, head) pairs.
// All three take a branch of their own, uniform over the warpgroup, on
// tiles wholly inside the mask (below the causal diagonal, in bounds, no
// segments or positions); the others mask by selects.
//
// Grid, and what replaces the TPU's serial grid axis:
//   * forward and dq: one block per (query tile, batch * q head); the block
//     walks the key tiles itself, up to the diagonal when causal by index,
//     over all of them when positions are given (the diagonal is then data
//     dependent, as in the Pallas skip rule);
//   * dkv: one block per (key tile, batch * kv head); the block walks every
//     (group member, query tile) pair itself, from the first query tile that
//     reaches its keys when causal by index.
//
// What bounds them on an H100: at the 600m training shape (B 10, T 2048,
// 16 q / 8 kv heads, D 96, causal) the forward does 4 * D flops per
// unmasked (row, key) pair and reads ~190 MB, so it is bound by the tensor
// cores (~0.13 ms at 989 TFLOP/s), dq by 6 and dkv by 8 flops per pair.
// The forward's products and copies are Hopper's (wgmma, TMA, a producer
// warpgroup); what sets its time is each consumer warpgroup's chain per
// tile, S = Q K^T, then the softmax (64 exponentials a thread, and the
// SM's 16 a clock), then P V, with little overlap between the two
// warpgroups.  Overlapping them (the next S, or the last P V, issued
// under the softmax; the warpgroups taking turns to issue) needs about 190
// registers a thread, and ptxas compiles the consumers for the 168 of
// the launch bounds whatever setmaxnreg grants at run time: the spills
// make it serialise every wgmma.  The backward kernels chain their
// products per tile the same way (two products, the element work, one or
// two products), the two consumer warpgroups of a block overlapping each
// other's element work with their products.  Timed alone, no single part
// of that chain dominates: at the training shape leaving out the
// exponentials, the later loads, the first or the second products, or
// adding a third warpgroup, moved #2 and #3 by at most a fifth each.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (accelerate_tpu_torch/ops/_build.py)

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// the element type of q / k / v / g and the outputs: bf16, or f16 when F16
template <bool F16>
using Elem = typename std::conditional<F16, __half, __nv_bfloat16>::type;

using hopper::pack2;

constexpr float kMaskValue = -0.7f * 3.402823466e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
    const void* q;      // bf16 or f16 (the instance's Elem), as are g and the outputs
    const void* k;
    const void* v;
    const int* seg_q;
    const int* seg_kv;
    const int* pos_q;
    const int* pos_kv;
    const void* g;
    const float* lse_in;
    const float* delta;
    void* out;
    float* lse_out;
    void* dq;
    void* dk;
    void* dv;
    int B, T, S, H, Hkv, causal;
    float sm_scale;
};

// -- helpers ---------------------------------------------------------------

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// -- kernel #1: forward, on the tensor cores ------------------------------

constexpr int FWD_BM = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int FWD_BN = 128;        // keys per tile
constexpr int FWD_STAGES = 3;      // K / V tiles in flight
constexpr int FWD_THREADS = 384;   // a producer warpgroup, two consumer warpgroups
constexpr int FWD_PRODUCER_REGS = 24;
constexpr int FWD_CONSUMER_REGS = 240;
constexpr int FWD_GROUP = 8;       // (batch, head) pairs whose query tiles run heaviest first

template <int D>
struct FwdPlan {
    static constexpr int kChunks = (D + 63) / 64;                // 64-column chunks
    static constexpr int kQBytes = kChunks * FWD_BM * 128;      // Q [chunk][128 rows][128 B]
    static constexpr int kKVBytes = kChunks * FWD_BN * 128;     // one K or V tile
    static constexpr int kQ = 0;
    static constexpr int kStage = kQBytes;   // stage s: K at kStage + 2 s kKVBytes, V after it
    static constexpr int kBar = kStage + FWD_STAGES * 2 * kKVBytes;
    // q_full, k_full[stages], v_full[stages], k_empty[stages], v_empty[stages]
    static constexpr size_t kBytes = (size_t)kBar + 8 * (1 + 4 * FWD_STAGES) + 1024;
};

template <int D, bool F16>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
    using L = FwdPlan<D>;
    constexpr int S = FWD_STAGES;
    constexpr int KSTEPS = D / 16;

    extern __shared__ unsigned char smem_raw[];
    // the swizzled tiles need 1024-byte aligned shared addresses
    unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
    const uint32_t sbase = hopper::smem_u32(smem);
    const uint32_t q_full = sbase + L::kBar;   // TMA landed: one arrival + bytes
    const uint32_t k_full0 = q_full + 8;
    const uint32_t v_full0 = k_full0 + 8 * S;
    // a stage's K (V) read: one thread of each consumer warp arrives
    const uint32_t k_empty0 = v_full0 + 8 * S;
    const uint32_t v_empty0 = k_empty0 + 8 * S;

    // heaviest causal tiles first, within groups of FWD_GROUP (batch, head)
    // pairs launched together (their K and V stay in L2)
    const int n_qt = gridDim.x;
    const int bh_all = p.B * p.H;
    const int lin = blockIdx.y * n_qt + blockIdx.x;
    const int grp = lin / (n_qt * FWD_GROUP), in_grp = lin % (n_qt * FWD_GROUP);
    const int grp_size = min(FWD_GROUP, bh_all - grp * FWD_GROUP);
    const int qt = n_qt - 1 - in_grp / grp_size;
    const int bh = grp * FWD_GROUP + in_grp % grp_size;
    const int b = bh / p.H, h = bh % p.H;
    const int hk = h / (p.H / p.Hkv);
    const int q0 = qt * FWD_BM;
    const bool segmented = p.seg_q != nullptr, positioned = p.pos_q != nullptr;
    int n_kt = (p.S + FWD_BN - 1) / FWD_BN;
    if (p.causal && !positioned) n_kt = min(n_kt, (min(q0 + FWD_BM, p.T) - 1) / FWD_BN + 1);
    const int tid = threadIdx.x;

    if (tid == 0) {
        hopper::mbar_init(q_full, 1);
        for (int st = 0; st < S; ++st) {
            hopper::mbar_init(k_full0 + 8 * st, 1);
            hopper::mbar_init(v_full0 + 8 * st, 1);
            hopper::mbar_init(k_empty0 + 8 * st, 8);
            hopper::mbar_init(v_empty0 + 8 * st, 8);
        }
        hopper::mbar_init_fence();
    }
    __syncthreads();

    const int wg = tid >> 7;
    if (wg == 0) {
        // producer: Q once, then K and V of each key tile, S tiles ahead of
        // the consumers; a stage's K is refilled as soon as both consumers'
        // S = Q K^T has read it, its V once their P V has
        hopper::setmaxnreg_dec<FWD_PRODUCER_REGS>();
        if (tid == 0) {
            hopper::mbar_arrive_expect_tx(q_full, L::kQBytes);
            for (int c = 0; c < L::kChunks; ++c)
                hopper::tma_load_4d(sbase + L::kQ + c * FWD_BM * 128, &tm_q, q_full, 64 * c, h,
                                    q0, b);
            for (int j = 0; j < n_kt; ++j) {
                const int st = j % S;
                const uint32_t ks = sbase + L::kStage + st * 2 * L::kKVBytes;
                const uint32_t kf = k_full0 + 8 * st, vf = v_full0 + 8 * st;
                if (j >= S) hopper::mbar_wait(k_empty0 + 8 * st, ((j / S) - 1) & 1);
                hopper::mbar_arrive_expect_tx(kf, L::kKVBytes);
                for (int c = 0; c < L::kChunks; ++c)
                    hopper::tma_load_4d(ks + c * FWD_BN * 128, &tm_k, kf, 64 * c, hk,
                                        j * FWD_BN, b);
                if (j >= S) hopper::mbar_wait(v_empty0 + 8 * st, ((j / S) - 1) & 1);
                hopper::mbar_arrive_expect_tx(vf, L::kKVBytes);
                for (int c = 0; c < L::kChunks; ++c)
                    hopper::tma_load_4d(ks + L::kKVBytes + c * FWD_BN * 128, &tm_v, vf, 64 * c,
                                        hk, j * FWD_BN, b);
            }
        }
        return;
    }
    hopper::setmaxnreg_inc<FWD_CONSUMER_REGS>();

    // consumer warpgroup cw owns query rows r0 .. r0 + 63
    const int cw = wg - 1;
    const bool lead = (tid & 31) == 0;   // a warp's products are done when its wait is
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + 64 * cw;
    const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    const bool row_in[2] = {row[0] < p.T, row[1] < p.T};
    const bool causal = p.causal != 0;
    int sq[2] = {0, 0}, pq[2] = {0, 0};
    for (int r = 0; r < 2; ++r) {
        if (row_in[r]) {
            if (segmented) sq[r] = p.seg_q[(size_t)b * p.T + row[r]];
            if (positioned) pq[r] = p.pos_q[(size_t)b * p.T + row[r]];
        }
    }
    const int* seg_k = segmented ? p.seg_kv + (size_t)b * p.S : nullptr;
    const int* pos_k = positioned ? p.pos_kv + (size_t)b * p.S : nullptr;
    // scores in base-2 units
    const float scale2 = p.sm_scale * kLog2e;
    const uint32_t qa = sbase + L::kQ + cw * 64 * 128;   // this warpgroup's A rows

    float acc[L::kChunks][32];
#pragma unroll
    for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};

    hopper::mbar_wait(q_full, 0);
    for (int j = 0; j < n_kt; ++j) {
        const int st = j % S;
        const uint32_t parity = (j / S) & 1;
        const uint32_t ks = sbase + L::kStage + st * 2 * L::kKVBytes;
        const uint32_t vs = ks + L::kKVBytes;

        // S = Q K^T over the D / 16 k-steps
        float sc[64];
        hopper::mbar_wait(k_full0 + 8 * st, parity);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
            hopper::wgmma_m64n128k16_ss<F16>(
                sc, hopper::sw128_desc(qa + (kk >> 2) * FWD_BM * 128 + (kk & 3) * 32),
                hopper::sw128_desc(ks + (kk >> 2) * FWD_BN * 128 + (kk & 3) * 32), kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 64; ++e) hopper::fence_operand(sc[e]);
        if (lead) hopper::mbar_arrive(k_empty0 + 8 * st);   // this tile's K is read

        // scale, mask and the online softmax, in registers; a tile wholly
        // inside the mask takes a branch of its own, uniform over the block
        const int k0 = j * FWD_BN;
        const bool unmasked = !segmented && !positioned && r0 + 64 <= p.T &&
                              k0 + FWD_BN <= p.S && (!causal || r0 >= k0 + FWD_BN - 1);
        float mx[2] = {-INFINITY, -INFINITY};
        if (unmasked) {
#pragma unroll
            for (int e = 0; e < 64; ++e) {
                sc[e] *= scale2;
                mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
            }
        } else {
            // the diagonal, the ragged edge, segments or positions: each
            // score against its mask by selects, no branch per element
#pragma unroll
            for (int jb = 0; jb < FWD_BN / 8; ++jb) {
#pragma unroll
                for (int c01 = 0; c01 < 2; ++c01) {
                    const int col = k0 + 8 * jb + 2 * t4 + c01;
                    const bool in = col < p.S;
                    const int cc = in ? col : p.S - 1;
                    const int sk = segmented ? __ldg(seg_k + cc) : 0;
                    const int pk = positioned ? __ldg(pos_k + cc) : 0;
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int e = 4 * jb + 2 * hh + c01;
                        const bool before = positioned ? pq[hh] >= pk : row[hh] >= col;
                        const bool ok = row_in[hh] && (!causal || before) &&
                                        (!segmented || sq[hh] == sk);
                        const float x = sc[e] * scale2;
                        sc[e] = !in ? -INFINITY : (ok ? x : kMaskValue);
                        mx[hh] = fmaxf(mx[hh], sc[e]);
                    }
                }
            }
        }
        float alpha[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const float m_new = fmaxf(m_run[hh], quad_max(mx[hh]));   // finite: key 0 < S
            alpha[hh] = exp2_approx(m_run[hh] - m_new);
            m_run[hh] = m_new;
        }
        float rs[2] = {0.f, 0.f};
        uint32_t pf[FWD_BN / 16][4];
#pragma unroll
        for (int jb = 0; jb < FWD_BN / 8; ++jb) {
            float pv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                pv[e] = exp2_approx(sc[4 * jb + e] - m_run[e >> 1]);
                rs[e >> 1] += pv[e];
            }
            // k-step jb / 2 of P V: a0 / a1 from the even 8-column block,
            // a2 / a3 from the odd one
            pf[jb >> 1][(jb & 1) * 2 + 0] = pack2<F16>(pv[0], pv[1]);
            pf[jb >> 1][(jb & 1) * 2 + 1] = pack2<F16>(pv[2], pv[3]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + rs[hh];
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[c][e] *= alpha[(e >> 1) & 1];

        // acc += P V, 64 head-dim columns per wgmma (32 for D 96's tail)
        hopper::mbar_wait(v_full0 + 8 * st, parity);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < FWD_BN / 16; ++kk) {
#pragma unroll
            for (int c = 0; c < L::kChunks; ++c) {
                const uint64_t desc = hopper::sw128_desc(vs + c * FWD_BN * 128 + kk * 2048);
                if (D - 64 * c >= 64) {
                    hopper::wgmma_m64n64k16_rs<1, F16>(acc[c], pf[kk], desc);
                } else {
                    hopper::wgmma_m64n32k16_rs<1, F16>(acc[c], pf[kk], desc);
                }
            }
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < FWD_BN / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) hopper::fence_operand(pf[kk][e]);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
#pragma unroll
            for (int e = 0; e < 32; ++e) hopper::fence_operand(acc[c][e]);
        if (lead) hopper::mbar_arrive(v_empty0 + 8 * st);   // and its V
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        const float lt = quad_sum(l_run[hh]);
        const float safe_l = lt == 0.f ? 1.f : lt;
        if (row[hh] >= p.T) continue;
        Elem<F16>* orow = static_cast<Elem<F16>*>(p.out) + (((size_t)b * p.T + row[hh]) * p.H + h) * D;
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
#pragma unroll
            for (int jb = 0; jb < 8; ++jb) {
                if (64 * c + 8 * jb >= D) continue;
                *reinterpret_cast<uint32_t*>(orow + 64 * c + 8 * jb + 2 * t4) =
                    pack2<F16>(acc[c][4 * jb + 2 * hh] / safe_l, acc[c][4 * jb + 2 * hh + 1] / safe_l);
            }
        }
        // lse in natural units; a row that every key masks has m at the
        // mask value itself, as the plain version has
        const float m_nat = m_run[hh] == kMaskValue ? kMaskValue : m_run[hh] * kLn2;
        if (t4 == 0) p.lse_out[((size_t)b * p.H + h) * p.T + row[hh]] = m_nat + logf(safe_l);
    }
}

// -- kernels #2 and #3: the backward, on the tensor cores -------------------

constexpr int BWD_THREADS = 256;   // two consumer warpgroups; thread 0 also loads
constexpr int BWD_ROWS = 64;       // query rows (dq) or keys (dkv) of a warpgroup
constexpr int BWD_CHUNK = BWD_ROWS * 128;   // a 64-row, 64-column swizzled chunk
constexpr int BWD_NO_KEY = 0x7fffffff;

// (tile, batch * head) of this block: heaviest first within groups of
// FWD_GROUP (batch, head) pairs launched together, so that their operands
// stay in L2; the heaviest tile is the last (dq) or the first (dkv)
struct BlockTile {
    int tile, bh;
};

__device__ __forceinline__ BlockTile block_tile(int n_bh, bool heaviest_last) {
    const int n_t = gridDim.x;
    const int lin = blockIdx.y * n_t + blockIdx.x;
    const int grp = lin / (n_t * FWD_GROUP), in_grp = lin % (n_t * FWD_GROUP);
    const int grp_size = min(FWD_GROUP, n_bh - grp * FWD_GROUP);
    const int rank = in_grp / grp_size;
    return {heaviest_last ? n_t - 1 - rank : rank, grp * FWD_GROUP + in_grp % grp_size};
}

template <int D>
struct DqPlan {
    // keys per tile: 128 (S and dP as m64n128 products) where the
    // registers allow it, in two stages; 64 at D 128, in four
    static constexpr int kBK = D <= 96 ? 128 : 64;
    static constexpr int kStages = kBK == 128 ? 2 : 4;
    static constexpr int kChunks = (D + 63) / 64;
    static constexpr int kTile = kChunks * BWD_CHUNK;   // 64 rows of Q or dO
    static constexpr int kKV = kChunks * kBK * 128;     // a K or V tile
    static constexpr int kQ = 0;                        // Q [warpgroup][chunk][64 rows][128 B]
    static constexpr int kG = 2 * kTile;                // dO, the same
    static constexpr int kStage = 4 * kTile;   // stage s: K at kStage + 2 s kKV, V after it
    static constexpr int kBar = kStage + kStages * 2 * kKV;
    // qg_full, k_full[stages], v_full[stages], empty[stages]
    static constexpr size_t kBytes = (size_t)kBar + 8 * (1 + 3 * kStages) + 1024;
};

template <int D, bool F16>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_g,
                const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const Params p) {
    using L = DqPlan<D>;
    constexpr int S = L::kStages;
    constexpr int BK = L::kBK;
    constexpr int KSTEPS = D / 16;

    extern __shared__ unsigned char smem_raw[];
    // the swizzled tiles need 1024-byte aligned shared addresses
    unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
    const uint32_t sbase = hopper::smem_u32(smem);
    const uint32_t qg_full = sbase + L::kBar;   // TMA landed: one arrival + bytes
    const uint32_t k_full0 = qg_full + 8;
    const uint32_t v_full0 = k_full0 + 8 * S;
    // a stage read: one thread of each consumer warp arrives
    const uint32_t empty0 = v_full0 + 8 * S;

    const BlockTile tile = block_tile(p.B * p.H, true);
    const int b = tile.bh / p.H, h = tile.bh % p.H;
    const int hk = h / (p.H / p.Hkv);
    const int q0 = tile.tile * 2 * BWD_ROWS;
    const bool segmented = p.seg_q != nullptr, positioned = p.pos_q != nullptr;
    const bool causal = p.causal != 0;
    int n_kt = (p.S + BK - 1) / BK;
    if (causal && !positioned) n_kt = min(n_kt, (min(q0 + 2 * BWD_ROWS, p.T) - 1) / BK + 1);
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;

    if (tid == 0) {
        hopper::mbar_init(qg_full, 1);
        for (int st = 0; st < S; ++st) {
            hopper::mbar_init(k_full0 + 8 * st, 1);
            hopper::mbar_init(v_full0 + 8 * st, 1);
            hopper::mbar_init(empty0 + 8 * st, 8);
        }
        hopper::mbar_init_fence();
    }
    __syncthreads();

    // thread 0 loads: key tile j into stage j % S, K and V on barriers of
    // their own, once both warpgroups have released the tile S before it
    auto load_kv = [&](int j) {
        const int st = j % S;
        const uint32_t ks = sbase + L::kStage + st * 2 * L::kKV;
        const uint32_t kf = k_full0 + 8 * st, vf = v_full0 + 8 * st;
        if (j >= S) hopper::mbar_wait(empty0 + 8 * st, ((j / S) - 1) & 1);
        hopper::mbar_arrive_expect_tx(kf, L::kKV);
        for (int c = 0; c < L::kChunks; ++c)
            hopper::tma_load_4d(ks + c * BK * 128, &tm_k, kf, 64 * c, hk, j * BK, b);
        hopper::mbar_arrive_expect_tx(vf, L::kKV);
        for (int c = 0; c < L::kChunks; ++c)
            hopper::tma_load_4d(ks + L::kKV + c * BK * 128, &tm_v, vf, 64 * c, hk, j * BK, b);
    };
    if (tid == 0) {
        hopper::mbar_arrive_expect_tx(qg_full, 4 * L::kTile);
        for (int w = 0; w < 2; ++w) {
            for (int c = 0; c < L::kChunks; ++c) {
                const int off = (w * L::kChunks + c) * BWD_CHUNK;
                hopper::tma_load_4d(sbase + L::kQ + off, &tm_q, qg_full, 64 * c, h,
                                    q0 + BWD_ROWS * w, b);
                hopper::tma_load_4d(sbase + L::kG + off, &tm_g, qg_full, 64 * c, h,
                                    q0 + BWD_ROWS * w, b);
            }
        }
        for (int j = 0; j < min(S, n_kt); ++j) load_kv(j);
    }

    // consumer warpgroup cw owns query rows r0 .. r0 + 63
    const int cw = warp >> 2, wq = warp & 3;
    const bool lead = lane == 0;   // a warp's products are done when its wait is
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + BWD_ROWS * cw;
    const int row[2] = {r0 + 16 * wq + g, r0 + 16 * wq + g + 8};
    const bool row_in[2] = {row[0] < p.T, row[1] < p.T};
    int sq[2] = {0, 0}, pq[2] = {0, 0};
    // -lse in base-2 units and delta * sm_scale of each of the thread's rows
    float nlse[2] = {0.f, 0.f}, dsc[2] = {0.f, 0.f};
    for (int r = 0; r < 2; ++r) {
        if (row_in[r]) {
            const size_t lrow = ((size_t)b * p.H + h) * p.T + row[r];
            nlse[r] = -p.lse_in[lrow] * kLog2e;
            dsc[r] = p.delta[lrow] * p.sm_scale;
            if (segmented) sq[r] = p.seg_q[(size_t)b * p.T + row[r]];
            if (positioned) pq[r] = p.pos_q[(size_t)b * p.T + row[r]];
        }
    }
    const int* seg_k = segmented ? p.seg_kv + (size_t)b * p.S : nullptr;
    const int* pos_k = positioned ? p.pos_kv + (size_t)b * p.S : nullptr;
    const float scale2 = p.sm_scale * kLog2e;
    // the last key this warpgroup's rows attend, when causal by index
    const int last_key = r0 >= p.T ? -1
                         : (causal && !positioned) ? r0 + BWD_ROWS - 1 : BWD_NO_KEY;
    const uint32_t qa = sbase + L::kQ + cw * L::kTile;   // this warpgroup's A rows
    const uint32_t ga = sbase + L::kG + cw * L::kTile;

    // dQ: element 4 j + 2 hh + c01 is row 8 hh + g, column 8 j + 2 t4 + c01
    float acc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

    hopper::mbar_wait(qg_full, 0);
    for (int j = 0; j < n_kt; ++j) {
        const int st = j % S;
        const uint32_t parity = (j / S) & 1;
        const uint32_t ks = sbase + L::kStage + st * 2 * L::kKV;
        const uint32_t vs = ks + L::kKV;
        const int k0 = j * BK;
        // the tile S - 1 ahead, into the stage of tile j - 1, which the
        // other warpgroup has most likely released by now
        if (tid == 0 && j >= 1 && j + S - 1 < n_kt) load_kv(j + S - 1);
        if (k0 > last_key) {
            // nothing here for these rows: wait for the tile, so that the
            // stage's release counts it, and release it
            hopper::mbar_wait(k_full0 + 8 * st, parity);
            hopper::mbar_wait(v_full0 + 8 * st, parity);
            if (lead) hopper::mbar_arrive(empty0 + 8 * st);
            continue;
        }

        // S = Q K^T, then dP = dO V^T, over the D / 16 k-steps
        float sc[BK / 2], dp[BK / 2];
        hopper::mbar_wait(k_full0 + 8 * st, parity);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
            hopper::wgmma_ss<BK, F16>(sc, hopper::sw128_desc(qa + (kk >> 2) * BWD_CHUNK + (kk & 3) * 32),
                                 hopper::sw128_desc(ks + (kk >> 2) * BK * 128 + (kk & 3) * 32),
                                 kk > 0);
        }
        hopper::wgmma_commit();
        hopper::mbar_wait(v_full0 + 8 * st, parity);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
            hopper::wgmma_ss<BK, F16>(dp, hopper::sw128_desc(ga + (kk >> 2) * BWD_CHUNK + (kk & 3) * 32),
                                 hopper::sw128_desc(vs + (kk >> 2) * BK * 128 + (kk & 3) * 32),
                                 kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) hopper::fence_operand(sc[e]);

        // p = exp(s - lse) on the valid set, 0 off it, while dP runs; a tile
        // wholly inside the mask takes a branch of its own, uniform over the
        // warpgroup
        const bool unmasked = !segmented && !positioned && r0 + BWD_ROWS <= p.T &&
                              k0 + BK <= p.S && (!causal || r0 >= k0 + BK - 1);
        if (unmasked) {
#pragma unroll
            for (int e = 0; e < BK / 2; ++e)
                sc[e] = exp2_approx(fmaf(sc[e], scale2, nlse[(e >> 1) & 1]));
        } else {
#pragma unroll
            for (int jb = 0; jb < BK / 8; ++jb) {
#pragma unroll
                for (int c01 = 0; c01 < 2; ++c01) {
                    const int col = k0 + 8 * jb + 2 * t4 + c01;
                    const bool in = col < p.S;
                    const int cc = in ? col : p.S - 1;
                    const int sk = segmented ? __ldg(seg_k + cc) : 0;
                    const int pk = positioned ? __ldg(pos_k + cc) : 0;
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int e = 4 * jb + 2 * hh + c01;
                        const bool before = positioned ? pq[hh] >= pk : row[hh] >= col;
                        const bool ok = in && row_in[hh] && (!causal || before) &&
                                        (!segmented || sq[hh] == sk);
                        const float x = exp2_approx(fmaf(sc[e], scale2, nlse[hh]));
                        sc[e] = ok ? x : 0.f;
                    }
                }
            }
        }
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) hopper::fence_operand(dp[e]);

        // ds = p (dp - delta) scale, rounded to bf16: k-step jb / 2 of
        // dQ += dS K takes a0 / a1 from the even 8-column block, a2 / a3
        // from the odd one
        uint32_t dsf[BK / 16][4];
#pragma unroll
        for (int jb = 0; jb < BK / 8; ++jb) {
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                ds[e] = sc[4 * jb + e] * fmaf(dp[4 * jb + e], p.sm_scale, -dsc[e >> 1]);
            dsf[jb >> 1][(jb & 1) * 2 + 0] = pack2<F16>(ds[0], ds[1]);
            dsf[jb >> 1][(jb & 1) * 2 + 1] = pack2<F16>(ds[2], ds[3]);
        }

        // dQ += dS K, one wgmma of all D head-dim columns per 16 keys
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            hopper::wgmma_rs_mn<D, F16>(acc, dsf[kk], hopper::sw128_desc(ks + kk * 2048, BK * 128));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) hopper::fence_operand(dsf[kk][e]);
        if (lead) hopper::mbar_arrive(empty0 + 8 * st);   // this tile's K and V are read
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        if (!row_in[hh]) continue;
        Elem<F16>* drow = static_cast<Elem<F16>*>(p.dq) + (((size_t)b * p.T + row[hh]) * p.H + h) * D + 2 * t4;
#pragma unroll
        for (int jb = 0; jb < D / 8; ++jb)
            *reinterpret_cast<uint32_t*>(drow + 8 * jb) =
                pack2<F16>(acc[4 * jb + 2 * hh], acc[4 * jb + 2 * hh + 1]);
    }
}

template <int D>
struct DkvPlan {
    static constexpr int kChunks = (D + 63) / 64;
    static constexpr int BQ = D > 96 ? 32 : 64;            // query rows per tile
    static constexpr int kKV = kChunks * BWD_CHUNK;        // a warpgroup's 64 keys of K or V
    static constexpr int kQTile = kChunks * BQ * 128;      // a query tile of Q or dO
    static constexpr int kK = 0;                           // K [warpgroup][chunk][64 rows][128 B]
    static constexpr int kV = 2 * kKV;                     // V, the same
    static constexpr int kStages = 4;                      // query tiles in flight
    static constexpr int kStage = 4 * kKV;
    static constexpr int kStageBytes = 2 * kQTile;         // a stage: Q, then dO
    static constexpr int kBar = kStage + kStages * kStageBytes;
    // kv_full, q_full[stages], g_full[stages], q_empty[stages]
    static constexpr int kRows = kBar + 128;
    // lse and delta of BQ query rows, [warpgroup][2 buffers][lse, delta][BQ]
    static constexpr size_t kBytes = (size_t)kRows + 2 * 2 * 2 * BQ * 4 + 1024;
};

template <int D, bool F16>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_g,
                 const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                 const Params p) {
    using L = DkvPlan<D>;
    constexpr int S = L::kStages;
    constexpr int BQ = L::BQ;
    constexpr int KSTEPS = D / 16;

    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
    const uint32_t sbase = hopper::smem_u32(smem);
    const uint32_t kv_full = sbase + L::kBar;
    const uint32_t q_full0 = kv_full + 8;      // a stage's Q
    const uint32_t g_full0 = q_full0 + 8 * S;  // and its dO
    const uint32_t q_empty0 = g_full0 + 8 * S;

    const BlockTile tile = block_tile(p.B * p.Hkv, false);
    const int b = tile.bh / p.Hkv, hk = tile.bh % p.Hkv;
    const int group = p.H / p.Hkv;
    const int k0 = tile.tile * 2 * BWD_ROWS;
    const bool segmented = p.seg_q != nullptr, positioned = p.pos_q != nullptr;
    const bool causal = p.causal != 0;
    const int n_qt = (p.T + BQ - 1) / BQ;
    // query tiles with a row at or after this block's first key (causal by index)
    const int qt_first = (causal && !positioned) ? min(k0 / BQ, n_qt) : 0;
    const int per_head = n_qt - qt_first;
    const int n_it = group * per_head;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;

    if (tid == 0) {
        hopper::mbar_init(kv_full, 1);
        for (int st = 0; st < S; ++st) {
            hopper::mbar_init(q_full0 + 8 * st, 1);
            hopper::mbar_init(g_full0 + 8 * st, 1);
            hopper::mbar_init(q_empty0 + 8 * st, 8);
        }
        hopper::mbar_init_fence();
    }
    __syncthreads();

    // thread 0 loads: iteration it's Q and dO into stage it % S, on
    // barriers of their own, once both warpgroups have released the
    // iteration S before it
    auto load_q = [&](int it) {
        const int st = it % S;
        const int h = hk * group + it / per_head;
        const int q0 = (qt_first + it % per_head) * BQ;
        const uint32_t qs = sbase + L::kStage + st * L::kStageBytes;
        const uint32_t qf = q_full0 + 8 * st, gf = g_full0 + 8 * st;
        if (it >= S) hopper::mbar_wait(q_empty0 + 8 * st, ((it / S) - 1) & 1);
        hopper::mbar_arrive_expect_tx(qf, L::kQTile);
        for (int c = 0; c < L::kChunks; ++c)
            hopper::tma_load_4d(qs + c * BQ * 128, &tm_q, qf, 64 * c, h, q0, b);
        hopper::mbar_arrive_expect_tx(gf, L::kQTile);
        for (int c = 0; c < L::kChunks; ++c)
            hopper::tma_load_4d(qs + L::kQTile + c * BQ * 128, &tm_g, gf, 64 * c, h, q0, b);
    };
    if (tid == 0) {
        hopper::mbar_arrive_expect_tx(kv_full, 4 * L::kKV);
        for (int w = 0; w < 2; ++w) {
            for (int c = 0; c < L::kChunks; ++c) {
                const int off = (w * L::kChunks + c) * BWD_CHUNK;
                hopper::tma_load_4d(sbase + L::kK + off, &tm_k, kv_full, 64 * c, hk,
                                    k0 + BWD_ROWS * w, b);
                hopper::tma_load_4d(sbase + L::kV + off, &tm_v, kv_full, 64 * c, hk,
                                    k0 + BWD_ROWS * w, b);
            }
        }
        for (int it = 0; it < min(S, n_it); ++it) load_q(it);
    }

    // consumer warpgroup cw owns keys kr0 .. kr0 + 63
    const int cw = warp >> 2, wq = warp & 3;
    const bool lead = lane == 0;
    const int g = lane >> 2, t4 = lane & 3;
    const int kr0 = k0 + BWD_ROWS * cw;
    const int key[2] = {kr0 + 16 * wq + g, kr0 + 16 * wq + g + 8};
    const bool key_in[2] = {key[0] < p.S, key[1] < p.S};
    int sk[2] = {0, 0}, pk[2] = {0, 0};
    for (int r = 0; r < 2; ++r) {
        if (key_in[r]) {
            if (segmented) sk[r] = p.seg_kv[(size_t)b * p.S + key[r]];
            if (positioned) pk[r] = p.pos_kv[(size_t)b * p.S + key[r]];
        }
    }
    const float scale2 = p.sm_scale * kLog2e;
    const uint32_t ka = sbase + L::kK + cw * L::kKV;   // this warpgroup's A rows
    const uint32_t va = sbase + L::kV + cw * L::kKV;

    // element 4 j + 2 hh + c01: key row 8 hh + g, column 8 j + 2 t4 + c01
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) {
        dk[e] = 0.f;
        dv[e] = 0.f;
    }

    // lse (negated, in base-2 units) and delta of each iteration's query
    // rows pass through a double buffer of this warpgroup's in shared
    // memory: each of its first 2 BQ threads loads one of them from L2 an
    // iteration ahead of its use, and a named barrier per iteration orders
    // the writes of one buffer before its reads and the reads before the
    // next writes
    float* rows = reinterpret_cast<float*>(smem + L::kRows) + cw * 4 * BQ;
    const int wtid = tid & 127;
    auto fetch = [&](int it) {
        const int qi = (qt_first + it % per_head) * BQ + wtid % BQ;
        if (it >= n_it || wtid >= 2 * BQ || qi >= p.T) return 0.f;
        const size_t at = ((size_t)b * p.H + hk * group + it / per_head) * p.T + qi;
        return wtid < BQ ? -__ldg(p.lse_in + at) * kLog2e : __ldg(p.delta + at);
    };
    if (wtid < 2 * BQ) rows[wtid] = fetch(0);

    // dV += P^T dO and dK += dS^T Q of an iteration run on under the next
    // iteration's S^T and dP^T; `pending` is the stage they read until they
    // are retired
    int pending = -1;
    uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
    auto retire = [&]() {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                hopper::fence_operand(pf[kk][e]);
                hopper::fence_operand(dsf[kk][e]);
            }
        }
        if (lead) hopper::mbar_arrive(q_empty0 + 8 * pending);   // its Q and dO are read
        pending = -1;
    };

    hopper::mbar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
        const int st = it % S;
        const uint32_t parity = (it / S) & 1;
        const int q0 = (qt_first + it % per_head) * BQ;
        const uint32_t qs = sbase + L::kStage + st * L::kStageBytes;
        const uint32_t gs = qs + L::kQTile;
        // iteration it + 2, into the stage of iteration it - 2, whose
        // products both warpgroups have most likely retired by now
        if (tid == 0 && it >= S - 2 && it + 2 < n_it) load_q(it + 2);
        hopper::named_barrier(1 + cw, 128);   // this iteration's rows are in
        const float next = fetch(it + 1);
        const float* nlse = rows + (it & 1) * 2 * BQ;
        const float* dlt = nlse + BQ;
        if (kr0 >= p.S || (causal && !positioned && q0 + BQ - 1 < kr0)) {
            // nothing here for these keys: finish the products in flight,
            // wait for the tile, so that the stage's release counts it, and
            // release it
            hopper::wgmma_wait<0>();
            if (pending >= 0) retire();
            hopper::mbar_wait(q_full0 + 8 * st, parity);
            hopper::mbar_wait(g_full0 + 8 * st, parity);
            if (lead) hopper::mbar_arrive(q_empty0 + 8 * st);
        } else {
            // S^T = K Q^T, then dP^T = V dO^T: rows are this warpgroup's keys
            float sc[BQ / 2], dp[BQ / 2];
            hopper::mbar_wait(q_full0 + 8 * st, parity);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk) {
                hopper::wgmma_ss<BQ, F16>(
                    sc, hopper::sw128_desc(ka + (kk >> 2) * BWD_CHUNK + (kk & 3) * 32),
                    hopper::sw128_desc(qs + (kk >> 2) * BQ * 128 + (kk & 3) * 32), kk > 0);
            }
            hopper::wgmma_commit();
            hopper::mbar_wait(g_full0 + 8 * st, parity);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KSTEPS; ++kk) {
                hopper::wgmma_ss<BQ, F16>(
                    dp, hopper::sw128_desc(va + (kk >> 2) * BWD_CHUNK + (kk & 3) * 32),
                    hopper::sw128_desc(gs + (kk >> 2) * BQ * 128 + (kk & 3) * 32), kk > 0);
            }
            hopper::wgmma_commit();
            hopper::wgmma_wait<2>();   // the last iteration's dV and dK, if any
            if (pending >= 0) retire();
            hopper::wgmma_wait<1>();
#pragma unroll
            for (int e = 0; e < BQ / 2; ++e) hopper::fence_operand(sc[e]);

            // p^T = exp(s^T - lse) on the valid set, 0 off it, while dP^T
            // runs; element e of the accumulator is key row
            // 16 wq + g + 8 ((e >> 1) & 1), query column 8 (e >> 2) + 2 t4 + (e & 1)
            const bool unmasked = !segmented && !positioned && q0 + BQ <= p.T &&
                                  kr0 + BWD_ROWS <= p.S && (!causal || q0 >= kr0 + BWD_ROWS - 1);
            if (unmasked) {
#pragma unroll
                for (int jb = 0; jb < BQ / 8; ++jb) {
                    const float2 nl = *reinterpret_cast<const float2*>(nlse + 8 * jb + 2 * t4);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        sc[4 * jb + e] = exp2_approx(fmaf(sc[4 * jb + e], scale2,
                                                          (e & 1) ? nl.y : nl.x));
                    }
                }
            } else {
                const int* seg_q = segmented ? p.seg_q + (size_t)b * p.T : nullptr;
                const int* pos_q = positioned ? p.pos_q + (size_t)b * p.T : nullptr;
#pragma unroll
                for (int jb = 0; jb < BQ / 8; ++jb) {
#pragma unroll
                    for (int c01 = 0; c01 < 2; ++c01) {
                        const int lq = 8 * jb + 2 * t4 + c01;
                        const int qi = q0 + lq;
                        const bool in = qi < p.T;
                        const int qc = in ? qi : p.T - 1;
                        const int sq = segmented ? __ldg(seg_q + qc) : 0;
                        const int pq = positioned ? __ldg(pos_q + qc) : 0;
#pragma unroll
                        for (int hh = 0; hh < 2; ++hh) {
                            const int e = 4 * jb + 2 * hh + c01;
                            const bool before = positioned ? pq >= pk[hh] : qi >= key[hh];
                            const bool ok = in && key_in[hh] && (!causal || before) &&
                                            (!segmented || sq == sk[hh]);
                            const float x = exp2_approx(fmaf(sc[e], scale2, nlse[lq]));
                            sc[e] = ok ? x : 0.f;
                        }
                    }
                }
            }
            hopper::wgmma_wait<0>();
#pragma unroll
            for (int e = 0; e < BQ / 2; ++e) hopper::fence_operand(dp[e]);

            // ds^T = p^T (dp^T - delta) scale; p^T and ds^T rounded to bf16
            // as the A operands of dV += P^T dO and dK += dS^T Q (k-step
            // jb / 2: a0 / a1 from the even 8-column block, a2 / a3 from the
            // odd one)
#pragma unroll
            for (int jb = 0; jb < BQ / 8; ++jb) {
                const float2 dl = *reinterpret_cast<const float2*>(dlt + 8 * jb + 2 * t4);
                float ds[4];
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    ds[e] = sc[4 * jb + e] * (dp[4 * jb + e] - ((e & 1) ? dl.y : dl.x)) *
                            p.sm_scale;
                pf[jb >> 1][(jb & 1) * 2 + 0] = pack2<F16>(sc[4 * jb + 0], sc[4 * jb + 1]);
                pf[jb >> 1][(jb & 1) * 2 + 1] = pack2<F16>(sc[4 * jb + 2], sc[4 * jb + 3]);
                dsf[jb >> 1][(jb & 1) * 2 + 0] = pack2<F16>(ds[0], ds[1]);
                dsf[jb >> 1][(jb & 1) * 2 + 1] = pack2<F16>(ds[2], ds[3]);
            }

            // dV += P^T dO and dK += dS^T Q, one wgmma of all D head-dim
            // columns each per 16 queries
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BQ / 16; ++kk) {
                hopper::wgmma_rs_mn<D, F16>(dv, pf[kk], hopper::sw128_desc(gs + kk * 2048, BQ * 128));
                hopper::wgmma_rs_mn<D, F16>(dk, dsf[kk], hopper::sw128_desc(qs + kk * 2048, BQ * 128));
            }
            hopper::wgmma_commit();
            pending = st;
        }
        if (wtid < 2 * BQ) rows[((it + 1) & 1) * 2 * BQ + wtid] = next;
    }
    hopper::wgmma_wait<0>();
    if (pending >= 0) retire();

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
        if (!key_in[hh]) continue;
        const size_t off = (((size_t)b * p.S + key[hh]) * p.Hkv + hk) * D + 2 * t4;
#pragma unroll
        for (int jb = 0; jb < D / 8; ++jb) {
            *reinterpret_cast<uint32_t*>(static_cast<Elem<F16>*>(p.dk) + off + 8 * jb) =
                pack2<F16>(dk[4 * jb + 2 * hh], dk[4 * jb + 2 * hh + 1]);
            *reinterpret_cast<uint32_t*>(static_cast<Elem<F16>*>(p.dv) + off + 8 * jb) =
                pack2<F16>(dv[4 * jb + 2 * hh], dv[4 * jb + 2 * hh + 1]);
        }
    }
}

// -- launch --------------------------------------------------------------

enum Kind { kFwd, kDq, kDkv };

// #1: the tensor maps of q [B, T, H, D] and k / v [B, S, Hkv, D] as 4-D
// (D, heads, sequence, batch) maps in 64-column boxes of FWD_BM (q) or
// FWD_BN (k, v) rows, 128-byte swizzle
template <int D, bool F16>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
    using L = FwdPlan<D>;
    const dim3 grid((p.T + FWD_BM - 1) / FWD_BM, p.B * p.H);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    CUtensorMap tm_q, tm_k, tm_v;
    const cuuint64_t row = (cuuint64_t)D * sizeof(Elem<F16>);
    const cuuint64_t q_dims[4] = {(cuuint64_t)D, (cuuint64_t)p.H, (cuuint64_t)p.T, (cuuint64_t)p.B};
    const cuuint64_t q_strides[3] = {row, row * p.H, row * p.H * p.T};
    const cuuint64_t kv_dims[4] = {(cuuint64_t)D, (cuuint64_t)p.Hkv, (cuuint64_t)p.S,
                                   (cuuint64_t)p.B};
    const cuuint64_t kv_strides[3] = {row, row * p.Hkv, row * p.Hkv * p.S};
    const cuuint32_t q_box[4] = {64, 1, FWD_BM, 1};
    const cuuint32_t kv_box[4] = {64, 1, FWD_BN, 1};
    const CUtensorMapDataType type =
        F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (!hopper::tensor_map_nd(&tm_q, type, 4, p.q, q_dims, q_strides, q_box,
                               CU_TENSOR_MAP_SWIZZLE_128B) ||
        !hopper::tensor_map_nd(&tm_k, type, 4, p.k, kv_dims, kv_strides, kv_box,
                               CU_TENSOR_MAP_SWIZZLE_128B) ||
        !hopper::tensor_map_nd(&tm_v, type, 4, p.v, kv_dims, kv_strides, kv_box,
                               CU_TENSOR_MAP_SWIZZLE_128B))
        return cudaErrorNotSupported;
    auto kernel = flash_fwd_kernel<D, F16>;
    // once per device: raise the shared-memory limit, and check that the
    // kernel was given the registers its warpgroups trade (setmaxnreg waits
    // for registers the block does not have, so it would never return;
    // ptxas gives a kernel with setmaxnreg its launch bounds' 168)
    static bool ready[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !ready[dev]) {
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return err;
        if (attr.numRegs * FWD_THREADS < 128 * FWD_PRODUCER_REGS + 256 * FWD_CONSUMER_REGS)
            return cudaErrorInvalidConfiguration;
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)L::kBytes);
        if (err != cudaSuccess) return err;
        if (dev < 64) ready[dev] = true;
    }
    kernel<<<grid, FWD_THREADS, L::kBytes, stream>>>(tm_q, tm_k, tm_v, p);
    return cudaGetLastError();
}

// a [B, L, heads, D] bf16 (f16) tensor as a 4-D map (D, heads, L, B) in
// 64-column boxes of `rows` rows, 128-byte swizzle
template <int D, bool F16>
bool head_map(CUtensorMap* map, const void* base, int B, int L, int heads, int rows) {
    const cuuint64_t row = (cuuint64_t)D * sizeof(Elem<F16>);
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)L, (cuuint64_t)B};
    const cuuint64_t strides[3] = {row, row * heads, row * heads * L};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
    return hopper::tensor_map_nd(map,
                                 F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                 4, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// #2
template <int D, bool F16>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
    using L = DqPlan<D>;
    const dim3 grid((p.T + 2 * BWD_ROWS - 1) / (2 * BWD_ROWS), p.B * p.H);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    CUtensorMap tm_q, tm_g, tm_k, tm_v;
    if (!head_map<D, F16>(&tm_q, p.q, p.B, p.T, p.H, BWD_ROWS) ||
        !head_map<D, F16>(&tm_g, p.g, p.B, p.T, p.H, BWD_ROWS) ||
        !head_map<D, F16>(&tm_k, p.k, p.B, p.S, p.Hkv, L::kBK) ||
        !head_map<D, F16>(&tm_v, p.v, p.B, p.S, p.Hkv, L::kBK))
        return cudaErrorNotSupported;
    auto kernel = flash_dq_kernel<D, F16>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, BWD_THREADS, L::kBytes, stream>>>(tm_q, tm_g, tm_k, tm_v, p);
    return cudaGetLastError();
}

// #3
template <int D, bool F16>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
    using L = DkvPlan<D>;
    const dim3 grid((p.S + 2 * BWD_ROWS - 1) / (2 * BWD_ROWS), p.B * p.Hkv);
    if (grid.y > 65535) return cudaErrorInvalidConfiguration;
    CUtensorMap tm_q, tm_g, tm_k, tm_v;
    if (!head_map<D, F16>(&tm_q, p.q, p.B, p.T, p.H, L::BQ) ||
        !head_map<D, F16>(&tm_g, p.g, p.B, p.T, p.H, L::BQ) ||
        !head_map<D, F16>(&tm_k, p.k, p.B, p.S, p.Hkv, BWD_ROWS) ||
        !head_map<D, F16>(&tm_v, p.v, p.B, p.S, p.Hkv, BWD_ROWS))
        return cudaErrorNotSupported;
    auto kernel = flash_dkv_kernel<D, F16>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, BWD_THREADS, L::kBytes, stream>>>(tm_q, tm_g, tm_k, tm_v, p);
    return cudaGetLastError();
}

template <int D, bool F16>
cudaError_t launch(Kind kind, const Params& p, cudaStream_t stream) {
    if (kind == kFwd) return launch_fwd<D, F16>(p, stream);
    if (kind == kDq) return launch_dq<D, F16>(p, stream);
    return launch_dkv<D, F16>(p, stream);
}

int run(int device, Kind kind, const Params& p, int D, bool f16, void* stream) {
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
        case 64: err = f16 ? launch<64, true>(kind, p, st) : launch<64, false>(kind, p, st); break;
        case 96: err = f16 ? launch<96, true>(kind, p, st) : launch<96, false>(kind, p, st); break;
        case 128:
            err = f16 ? launch<128, true>(kind, p, st) : launch<128, false>(kind, p, st);
            break;
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
    p.q = q;
    p.k = k;
    p.v = v;
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

// The bf16 entry points, and their f16 instances (``_f16``: the same
// kernels over f16 operands, p and ds rounded to f16 before their products).
#define FLASH_ENTRY_POINTS(SUFFIX, IS_F16)                                                       \
    /* out [B, T, H, D], lse [B, H, T] f32 */                                                    \
    int flash_attention_fwd_##SUFFIX(int device, const void* q, const void* k, const void* v,    \
                                     const void* seg_q, const void* seg_kv, const void* pos_q,   \
                                     const void* pos_kv, void* out, void* lse, int B, int T,     \
                                     int S, int H, int Hkv, int D, int causal, float sm_scale,   \
                                     void* stream) {                                             \
        Params p = base(q, k, v, seg_q, seg_kv, pos_q, pos_kv, B, T, S, H, Hkv, causal,         \
                        sm_scale);                                                               \
        p.out = out;                                                                             \
        p.lse_out = static_cast<float*>(lse);                                                    \
        return run(device, kFwd, p, D, IS_F16, stream);                                          \
    }                                                                                            \
    /* g / dq [B, T, H, D]; lse, delta [B, H, T] f32 */                                          \
    int flash_attention_dq_##SUFFIX(int device, const void* q, const void* k, const void* v,     \
                                    const void* seg_q, const void* seg_kv, const void* pos_q,    \
                                    const void* pos_kv, const void* g, const void* lse,          \
                                    const void* delta, void* dq, int B, int T, int S, int H,     \
                                    int Hkv, int D, int causal, float sm_scale, void* stream) {  \
        Params p = base(q, k, v, seg_q, seg_kv, pos_q, pos_kv, B, T, S, H, Hkv, causal,         \
                        sm_scale);                                                               \
        p.g = g;                                                                                 \
        p.lse_in = static_cast<const float*>(lse);                                               \
        p.delta = static_cast<const float*>(delta);                                              \
        p.dq = dq;                                                                               \
        return run(device, kDq, p, D, IS_F16, stream);                                           \
    }                                                                                            \
    /* dk / dv [B, S, Hkv, D] */                                                                 \
    int flash_attention_dkv_##SUFFIX(int device, const void* q, const void* k, const void* v,    \
                                     const void* seg_q, const void* seg_kv, const void* pos_q,   \
                                     const void* pos_kv, const void* g, const void* lse,         \
                                     const void* delta, void* dk, void* dv, int B, int T, int S, \
                                     int H, int Hkv, int D, int causal, float sm_scale,          \
                                     void* stream) {                                             \
        Params p = base(q, k, v, seg_q, seg_kv, pos_q, pos_kv, B, T, S, H, Hkv, causal,         \
                        sm_scale);                                                               \
        p.g = g;                                                                                 \
        p.lse_in = static_cast<const float*>(lse);                                               \
        p.delta = static_cast<const float*>(delta);                                              \
        p.dk = dk;                                                                               \
        p.dv = dv;                                                                               \
        return run(device, kDkv, p, D, IS_F16, stream);                                          \
    }

FLASH_ENTRY_POINTS(bf16, false)
FLASH_ENTRY_POINTS(f16, true)

#undef FLASH_ENTRY_POINTS

const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
