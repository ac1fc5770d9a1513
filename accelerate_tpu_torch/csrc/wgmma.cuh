// Hopper building blocks shared by the kernels of flash_attention.cu,
// paged_prefill.cu, paged_decode.cu and quantized_matmul.cu: cp.async
// copies, mbarriers and TMA loads (and, on the host, the tensor maps they
// read), register reallocation between warpgroups, thread-block cluster
// barriers and distributed shared-memory loads, the wgmma shared-memory
// descriptor of a 128-byte-swizzled bf16 tile, and the warpgroup
// matrix-multiply instructions the kernels issue.  Each product takes bf16
// operands, or f16 ones with its ``F16`` template argument (the same
// 2-byte tile layout; ``pack2<F16>`` rounds a register A fragment to it).
//
// Shared-memory tiles (sw128_offset): a bf16 tile is kept in chunks of 64
// columns; each chunk is rows of 128 bytes, 1024-byte aligned, and the
// 16-byte group c of row r sits at group c ^ (r % 8) (the hardware's
// 128-byte swizzle, so eight rows' reads of one group hit all 32 banks).
// One layout serves both operand majors:
//   * K-major (the row is the M or N index, the 64 columns are K): the K
//     tile of the attention kernel, the x tile of the matmul;
//   * MN-major (the row is the K index, the columns are N): the V tile of
//     the attention kernel, read with the transpose bit.
// A k16 step of a K-major operand starts 32 bytes further along the row
// (the swizzle is applied to the absolute address, so the chunk base must
// be 1024-byte aligned); a k16 step of an MN-major operand starts 16 rows
// (2048 bytes) further down.  Every instruction here reads at most 64
// columns of one chunk, so the descriptor's leading-byte offset is unused;
// its stride-byte offset is 1024, the distance between groups of 8 rows.
//
// An A operand in shared memory (wgmma_m64n128k16_ss, wgmma_ss) is a
// K-major tile of the same layout: 64 rows of 128 bytes per chunk, 8-row
// groups 1024 bytes apart, a k16 step 32 bytes along the row.
//
// Fragments (g = lane / 4, t = lane % 4, w = warp of the warpgroup):
//   * accumulator of m64nN: d[4j + 0, 1] = C[16w + g][8j + 2t, +1],
//     d[4j + 2, 3] = C[16w + g + 8][8j + 2t, +1];
//   * A from registers (m64k16): a0 = A[16w + g][2t, +1],
//     a1 = A[16w + g + 8][2t, +1], a2 = A[16w + g][2t + 8, +9],
//     a3 = A[16w + g + 8][2t + 8, +9], two bf16 per register.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared through L2 only; zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}

// 4 bytes global -> shared; zero-filled when !pred
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool pred) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(pred ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// make this thread's generic-proxy shared-memory writes visible to the
// async proxy that wgmma reads its shared-memory operands through
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin a register operand of an in-flight wgmma.  wgmma reads its register
// A fragments and writes its accumulators asynchronously, until the
// wgmma.wait_group that covers it, but to the compiler an "r" input of the
// asm is dead once the asm is issued: without a later use it may hand that
// register to another value (a fragment converted while the product runs)
// before the wait.  Passing each operand through this after the wait keeps
// the register holding it until then.
__device__ __forceinline__ void fence_operand(uint32_t& r) {
    asm volatile("" : "+r"(r) :: "memory");
}

__device__ __forceinline__ void fence_operand(float& r) {
    asm volatile("" : "+f"(r) :: "memory");
}

// byte offset of bf16 element (row, col) in a tile of 64-column chunks,
// each chunk `rows` rows of 128 bytes
__device__ __forceinline__ uint32_t sw128_offset(int row, int col, int rows) {
    const int chunk = col >> 6;
    const int group = (col & 63) >> 3;
    return (uint32_t)(chunk * rows * 128 + row * 128 + ((group ^ (row & 7)) << 4) +
                      ((col & 7) << 1));
}

// descriptor of a 128-byte-swizzled tile starting at shared address `addr`;
// `chunk_bytes`, the distance between its 64-column chunks, is the
// leading-byte offset an MN-major operand wider than 64 columns steps by
// (K-major operands and narrower ones never read it)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t chunk_bytes = 16) {
    uint64_t d = 0;
    d |= (uint64_t)((addr & 0x3FFFF) >> 4);   // start address, 16-byte units
    d |= (uint64_t)((chunk_bytes >> 4) & 0x3FFF) << 16;   // leading-byte offset
    d |= (uint64_t)(1024 >> 4) << 32;         // stride-byte offset: 8 rows
    d |= (uint64_t)1 << 62;                   // 128-byte swizzle
    return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// two floats rounded to the products' element type (f16 or bf16), packed
template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    if constexpr (F16) {
        return pack_f16(lo, hi);
    } else {
        return pack_bf16(lo, hi);
    }
}

// -- mbarriers and TMA -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// make the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// one arrival that also announces `bytes` of TMA transfers to wait for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

// a 2-D box of the tensor map at (c0 innermost, c1) into shared memory at
// dst, completing on the barrier; out-of-bounds elements arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* tmap, uint32_t bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

// a 4-D box of the tensor map at (c0 innermost, c1, c2, c3), as above
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tmap)), "r"(bar), "r"(c0), "r"(c1),
           "r"(c2), "r"(c3)
        : "memory");
}

// Move registers between the warpgroups of a block: every warp of the
// warpgroup executes it, and the count is a multiple of 8 in [24, 256].
// The block's pool is what it was launched with (the kernel's register
// count times its threads); an increase waits until a decrease elsewhere
// has freed enough.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// a barrier among `count` threads (whole warps) under id `id` (1-15; 0 is
// __syncthreads')
__device__ __forceinline__ void named_barrier(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// -- thread-block clusters ---------------------------------------------------
// Every thread of every block of the cluster executes each barrier; a block
// must not exit while a peer may still read its shared memory.

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
    cluster_arrive();
    cluster_wait();
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
    return r;
}

// the shared::cluster address of this block's shared address `addr` in the
// cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
    return remote;
}

// 16 bytes (4 bytes) of the shared memory of the cluster's block `rank` at
// the address `addr` has in this block's shared memory
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr, uint32_t rank) {
    float4 v;
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(cluster_map(addr, rank))
                 : "memory");
    return v;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr, uint32_t rank) {
    float v;
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(cluster_map(addr, rank))
                 : "memory");
    return v;
}

#define HOPPER_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                       "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A from registers, B from shared
// memory through `desc_b`; TRANS_B 0 for a K-major B, 1 for an MN-major B
#define HOPPER_WGMMA_M64N64K16_RS(AB) asm volatile( \
        "{\n" \
        ".reg .pred p;\n" \
        "setp.ne.b32 p, %38, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
        "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n" \
        "}\n" \
        : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TRANS_B), "r"(1))
template <int TRANS_B, bool F16 = false>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a, uint64_t desc_b) {
    if constexpr (F16) {
        HOPPER_WGMMA_M64N64K16_RS("f16");
    } else {
        HOPPER_WGMMA_M64N64K16_RS("bf16");
    }
}
#undef HOPPER_WGMMA_M64N64K16_RS

// d[64 x 96] += A[64 x 16] . B[16 x 96], as above (an MN-major B spans two
// chunks: its descriptor carries the chunk distance)
#define HOPPER_WGMMA_M64N96K16_RS(AB) asm volatile( \
        "{\n" \
        ".reg .pred p;\n" \
        "setp.ne.b32 p, %54, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n96k16.f32." AB "." AB " " \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, " \
        "{%48, %49, %50, %51}, %52, p, 1, 1, %53;\n" \
        "}\n" \
        : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), \
          HOPPER_ACC8(32), HOPPER_ACC8(40) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TRANS_B), "r"(1))
template <int TRANS_B, bool F16 = false>
__device__ __forceinline__ void wgmma_m64n96k16_rs(float* d, const uint32_t* a, uint64_t desc_b) {
    if constexpr (F16) {
        HOPPER_WGMMA_M64N96K16_RS("f16");
    } else {
        HOPPER_WGMMA_M64N96K16_RS("bf16");
    }
}
#undef HOPPER_WGMMA_M64N96K16_RS

// d[64 x 32] += A[64 x 16] . B[16 x 32], as above
#define HOPPER_WGMMA_M64N32K16_RS(AB) asm volatile( \
        "{\n" \
        ".reg .pred p;\n" \
        "setp.ne.b32 p, %22, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " " \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
        "{%16, %17, %18, %19}, %20, p, 1, 1, %21;\n" \
        "}\n" \
        : HOPPER_ACC8(0), HOPPER_ACC8(8) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TRANS_B), "r"(1))
template <int TRANS_B, bool F16 = false>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float* d, const uint32_t* a, uint64_t desc_b) {
    if constexpr (F16) {
        HOPPER_WGMMA_M64N32K16_RS("f16");
    } else {
        HOPPER_WGMMA_M64N32K16_RS("bf16");
    }
}
#undef HOPPER_WGMMA_M64N32K16_RS

// d[64 x 16] += A[64 x 16] . B[16 x 16], as above
#define HOPPER_WGMMA_M64N16K16_RS(AB) asm volatile( \
        "{\n" \
        ".reg .pred p;\n" \
        "setp.ne.b32 p, %14, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n16k16.f32." AB "." AB " " \
        "{%0, %1, %2, %3, %4, %5, %6, %7}, " \
        "{%8, %9, %10, %11}, %12, p, 1, 1, %13;\n" \
        "}\n" \
        : HOPPER_ACC8(0) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TRANS_B), "r"(1))
template <int TRANS_B, bool F16 = false>
__device__ __forceinline__ void wgmma_m64n16k16_rs(float* d, const uint32_t* a, uint64_t desc_b) {
    if constexpr (F16) {
        HOPPER_WGMMA_M64N16K16_RS("f16");
    } else {
        HOPPER_WGMMA_M64N16K16_RS("bf16");
    }
}
#undef HOPPER_WGMMA_M64N16K16_RS

// d[64 x 128] += A[64 x 16] . B[16 x 128], as above
#define HOPPER_WGMMA_M64N128K16_RS(AB) asm volatile( \
        "{\n" \
        ".reg .pred p;\n" \
        "setp.ne.b32 p, %70, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " " \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
        "{%64, %65, %66, %67}, %68, p, 1, 1, %69;\n" \
        "}\n" \
        : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), \
          HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56) \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "n"(TRANS_B), "r"(1))
template <int TRANS_B, bool F16 = false>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a, uint64_t desc_b) {
    if constexpr (F16) {
        HOPPER_WGMMA_M64N128K16_RS("f16");
    } else {
        HOPPER_WGMMA_M64N128K16_RS("bf16");
    }
}
#undef HOPPER_WGMMA_M64N128K16_RS

// d[64 x 128] = A[64 x 16] . B[16 x 128] (+ d if `accumulate`): A and B
// both K-major tiles in shared memory, through `desc_a` and `desc_b`
#define HOPPER_WGMMA_M64N128K16_SS(AB) asm volatile( \
        "{\n" \
        ".reg .pred p;\n" \
        "setp.ne.b32 p, %66, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " " \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
        "%64, %65, p, 1, 1, 0, 0;\n" \
        "}\n" \
        : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24), \
          HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56) \
        : "l"(desc_a), "l"(desc_b), "r"(accumulate))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                    int accumulate) {
    if constexpr (F16) {
        HOPPER_WGMMA_M64N128K16_SS("f16");
    } else {
        HOPPER_WGMMA_M64N128K16_SS("bf16");
    }
}
#undef HOPPER_WGMMA_M64N128K16_SS

// d[64 x 64] = A[64 x 16] . B[16 x 64] (+ d if `accumulate`), as above
#define HOPPER_WGMMA_M64N64K16_SS(AB) asm volatile( \
        "{\n" \
        ".reg .pred p;\n" \
        "setp.ne.b32 p, %34, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " " \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
        "%32, %33, p, 1, 1, 0, 0;\n" \
        "}\n" \
        : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24) \
        : "l"(desc_a), "l"(desc_b), "r"(accumulate))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
    if constexpr (F16) {
        HOPPER_WGMMA_M64N64K16_SS("f16");
    } else {
        HOPPER_WGMMA_M64N64K16_SS("bf16");
    }
}
#undef HOPPER_WGMMA_M64N64K16_SS

// d[64 x 32] = A[64 x 16] . B[16 x 32] (+ d if `accumulate`), as above
#define HOPPER_WGMMA_M64N32K16_SS(AB) asm volatile( \
        "{\n" \
        ".reg .pred p;\n" \
        "setp.ne.b32 p, %18, 0;\n" \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " " \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
        "%16, %17, p, 1, 1, 0, 0;\n" \
        "}\n" \
        : HOPPER_ACC8(0), HOPPER_ACC8(8) \
        : "l"(desc_a), "l"(desc_b), "r"(accumulate))
template <bool F16 = false>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
    if constexpr (F16) {
        HOPPER_WGMMA_M64N32K16_SS("f16");
    } else {
        HOPPER_WGMMA_M64N32K16_SS("bf16");
    }
}
#undef HOPPER_WGMMA_M64N32K16_SS

// the m64nNk16 product for N in {32, 64, 128}, A and B K-major in shared
// memory
template <int N, bool F16 = false>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
    static_assert(N == 32 || N == 64 || N == 128, "N 32, 64 or 128");
    if constexpr (N == 32) {
        wgmma_m64n32k16_ss<F16>(d, desc_a, desc_b, accumulate);
    } else if constexpr (N == 64) {
        wgmma_m64n64k16_ss<F16>(d, desc_a, desc_b, accumulate);
    } else {
        wgmma_m64n128k16_ss<F16>(d, desc_a, desc_b, accumulate);
    }
}

// the m64nNk16 product for N in {16, 64, 128}, B K-major
template <int N, bool F16 = false>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b) {
    static_assert(N == 16 || N == 64 || N == 128, "N 16, 64 or 128");
    if constexpr (N == 16) {
        wgmma_m64n16k16_rs<0, F16>(d, a, desc_b);
    } else if constexpr (N == 64) {
        wgmma_m64n64k16_rs<0, F16>(d, a, desc_b);
    } else {
        wgmma_m64n128k16_rs<0, F16>(d, a, desc_b);
    }
}

// d[64 x N] += A[64 x 16] . B[16 x N] for N in {64, 96, 128}, B MN-major
// (its descriptor carries the chunk distance)
template <int N, bool F16 = false>
__device__ __forceinline__ void wgmma_rs_mn(float* d, const uint32_t* a, uint64_t desc_b) {
    static_assert(N == 64 || N == 96 || N == 128, "N 64, 96 or 128");
    if constexpr (N == 64) {
        wgmma_m64n64k16_rs<1, F16>(d, a, desc_b);
    } else if constexpr (N == 96) {
        wgmma_m64n96k16_rs<1, F16>(d, a, desc_b);
    } else {
        wgmma_m64n128k16_rs<1, F16>(d, a, desc_b);
    }
}

#undef HOPPER_ACC8

// -- tensor maps (host) ------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, looked up once through the
// runtime (no link against libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
    static EncodeTiledFn fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                             cudaEnableDefault, &found) == cudaSuccess &&
            found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiledFn>(p);
    }
    return fn;
}

// a rank-`rank` tensor of `dims` elements (innermost first), `strides` the
// byte strides of dims 1 .. rank - 1, read in boxes of `box`; elements out
// of bounds read as zeros
inline bool tensor_map_nd(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                          const cuuint64_t* dims, const cuuint64_t* strides,
                          const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr || rank < 1 || rank > 5) return false;
    const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
    return fn(map, type, (cuuint32_t)rank, const_cast<void*>(base), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2-D row-major tensor [rows, cols] of `bytes`-wide elements, read in
// boxes of box_cols x box_rows
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* base,
                       int rows, int cols, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * bytes};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    return tensor_map_nd(map, type, 2, base, dims, strides, box, swizzle);
}

}  // namespace hopper
