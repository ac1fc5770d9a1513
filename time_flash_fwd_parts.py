#!/usr/bin/env python3
"""Cycles per key tile of the parts of kernel #1's consumer loop.

Run from the root of a checkout on a CUDA card:

    python3 time_flash_fwd_parts.py [--iters N]

Kernel #1 (``csrc/flash_attention.cu``, the flash forward) gives each
consumer warpgroup 64 query rows and walks 128-key tiles: S = Q K^T
(``wgmma`` m64n128k16, both operands in shared memory), the online softmax
in registers, then P V (``wgmma`` with P from registers, V MN-major).
This script builds a small CUDA program from the checkout's
``csrc/wgmma.cuh`` that runs those parts, alone and together, on tiles that
stay in shared memory (no loads, no masks), at the 600m model's head dim
96, in the kernel's block layout (384 threads: a producer warpgroup that
gives its registers away by ``setmaxnreg``, then two consumer warpgroups,
one or both running the parts), one block per SM for ``--iters`` tiles.
It also runs two ways of overlapping the parts: each warpgroup issuing the
next S and the last P V together before its softmax ("pipelined"), and
the two warpgroups taking turns to issue ("ping-pong").

Prints the card, then one JSON line per run: the parts, the warpgroups,
cycles per tile (``clock64`` in the consumers), microseconds per tile
(CUDA events), and from the build the kernel's registers, spilled bytes
and ``WARPGROUP.DEPBAR`` count (one per product when ptxas serialises the
products).  Exits 1 if the build or a launch fails.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

enum { kS = 1, kSoftmax = 2, kPV = 4, kPipelined = 8, kPingPong = 16 };

__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Q [2 chunks][128 rows], K [2][128], V [2][128] bf16 in the 128-byte
// swizzle, head dim 96.  The kernel's 384 threads: a producer warpgroup,
// then two consumer warpgroups of which CONSUMERS run the parts
template <int MODE, int CONSUMERS>
__global__ void __launch_bounds__(384, 1)
parts(float* out, long long* cycles, int iters) {
    extern __shared__ unsigned char raw[];
    unsigned char* smem = raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
    const uint32_t sb = hopper::smem_u32(smem);
    for (int i = threadIdx.x; i < 3 * 16384; i += blockDim.x)
        reinterpret_cast<bf16*>(smem)[i] =
            __float2bfloat16(((i * 2654435761u) % 1000) * 1e-4f - 0.05f);
    __syncthreads();
    hopper::fence_async_shared();
    __syncthreads();
    if (threadIdx.x < 128) {
        hopper::setmaxnreg_dec<24>();
        return;
    }
    hopper::setmaxnreg_inc<240>();
    const int tid = threadIdx.x - 128;
    const int cw = tid >> 7;
    if (cw >= CONSUMERS) return;
    const uint32_t qa = sb + cw * 64 * 128, ks = sb + 32768, vs = sb + 65536;
    const float scale2 = 0.147f;

    float acc[2][32], sc[64], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
    float alpha[2] = {1.f, 1.f};
    uint32_t pf[8][4], pn[8][4];
    for (int c = 0; c < 2; ++c)
        for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
    for (int e = 0; e < 64; ++e) sc[e] = (tid * 7 + e) * 1e-3f;
    for (int k = 0; k < 8; ++k)
        for (int e = 0; e < 4; ++e) pf[k][e] = pn[k][e] = 0x3c003c00u ^ (tid + k + e);

    auto issue_s = [&]() {
#pragma unroll
        for (int kk = 0; kk < 6; ++kk)
            hopper::wgmma_m64n128k16_ss(
                sc, hopper::sw128_desc(qa + (kk >> 2) * 128 * 128 + (kk & 3) * 32),
                hopper::sw128_desc(ks + (kk >> 2) * 128 * 128 + (kk & 3) * 32), kk > 0);
    };
    auto issue_pv = [&]() {
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
            hopper::wgmma_m64n64k16_rs<1>(acc[0], pf[kk], hopper::sw128_desc(vs + kk * 2048));
            hopper::wgmma_m64n32k16_rs<1>(acc[1], pf[kk],
                                          hopper::sw128_desc(vs + 128 * 128 + kk * 2048));
        }
    };
    auto softmax = [&]() {   // into pn and alpha
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < 64; ++e) {
            sc[e] *= scale2;
            mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const float mn = fmaxf(m_run[hh], quad_max(mx[hh]));
            alpha[hh] = exp2_approx(m_run[hh] - mn);
            m_run[hh] = mn;
        }
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int jb = 0; jb < 16; ++jb) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                p[e] = exp2_approx(sc[4 * jb + e] - m_run[e >> 1]);
                rs[e >> 1] += p[e];
            }
            pn[jb >> 1][(jb & 1) * 2] = hopper::pack_bf16(p[0], p[1]);
            pn[jb >> 1][(jb & 1) * 2 + 1] = hopper::pack_bf16(p[2], p[3]);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l_run[hh] = l_run[hh] * alpha[hh] + rs[hh];
    };
    auto rescale = [&]() {   // acc *= alpha; pn becomes the next P
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int e = 0; e < 32; ++e)
                if (c == 0 || e < 16) acc[c][e] *= alpha[(e >> 1) & 1];
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e) pf[k][e] = pn[k][e];
    };
    auto pin = [&]() {   // every product operand defined before a stage opens
#pragma unroll
        for (int e = 0; e < 64; ++e) hopper::fence_operand(sc[e]);
#pragma unroll
        for (int k = 0; k < 8; ++k)
#pragma unroll
            for (int e = 0; e < 4; ++e) hopper::fence_operand(pf[k][e]);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int e = 0; e < 32; ++e)
                if (c == 0 || e < 16) hopper::fence_operand(acc[c][e]);
    };
    auto turn = [&]() {
        if (MODE & kPingPong) hopper::named_barrier(1 + cw, 256);
    };
    auto pass = [&]() {
        if (MODE & kPingPong) asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + (cw ^ 1)) : "memory");
    };

    long long t0 = clock64();
    if (MODE & kPipelined) {
        // S(0) alone; then S(i) with P(i - 1) V under softmax(i); then P V
        if ((MODE & kPingPong) && cw == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
        turn();
        pin();
        hopper::wgmma_fence();
        issue_s();
        hopper::wgmma_commit();
        pass();
        hopper::wgmma_wait<0>();
        pin();
        softmax();
        rescale();
        for (int it = 1; it < iters; ++it) {
            turn();
            pin();
            hopper::wgmma_fence();
            issue_s();
            hopper::wgmma_commit();
            issue_pv();
            hopper::wgmma_commit();
            pass();
            hopper::wgmma_wait<1>();
            pin();
            softmax();
            hopper::wgmma_wait<0>();
            pin();
            rescale();
        }
        turn();
        pin();
        hopper::wgmma_fence();
        issue_pv();
        hopper::wgmma_commit();
        pass();
        hopper::wgmma_wait<0>();
        pin();
    } else {
        for (int it = 0; it < iters; ++it) {
            if (MODE & kS) {
                pin();
                hopper::wgmma_fence();
                issue_s();
                hopper::wgmma_commit();
                hopper::wgmma_wait<0>();
                pin();
            }
            if (MODE & kSoftmax) {
                softmax();
                rescale();
            }
            if (MODE & kPV) {
                pin();
                hopper::wgmma_fence();
                issue_pv();
                hopper::wgmma_commit();
                hopper::wgmma_wait<0>();
                pin();
            }
        }
    }
    long long t1 = clock64();
    float s = l_run[0] + l_run[1];
    for (int c = 0; c < 2; ++c)
        for (int e = 0; e < 32; ++e) s += acc[c][e];
    out[blockIdx.x * 256 + tid] = s;
    cycles[blockIdx.x * 256 + tid] = t1 - t0;
}

template <int MODE, int CONSUMERS>
int run(const char* name, int iters, int sms) {
    const int threads = 128 * CONSUMERS;
    float* out;
    long long* cyc;
    if (cudaMalloc(&out, sms * 256 * 4) != cudaSuccess ||
        cudaMalloc(&cyc, sms * 256 * 8) != cudaSuccess)
        return 1;
    const int smem = 3 * 32768 + 1024;
    auto kernel = parts<MODE, CONSUMERS>;
    // setmaxnreg waits for registers the block does not have: refuse a
    // build that was given fewer than the trade needs
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess ||
        attr.numRegs * 384 < 128 * 24 + 256 * 240) {
        fprintf(stderr, "%s: %d registers a thread, too few for setmaxnreg\n", name,
                attr.numRegs);
        return 1;
    }
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kernel<<<sms, 384, smem>>>(out, cyc, iters);   // warm-up
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    kernel<<<sms, 384, smem>>>(out, cyc, iters);
    cudaEventRecord(b);
    const cudaError_t err = cudaDeviceSynchronize();
    if (err != cudaSuccess) {
        fprintf(stderr, "%s: %s\n", name, cudaGetErrorString(err));
        return 1;
    }
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    long long host[256];
    cudaMemcpy(host, cyc, threads * 8, cudaMemcpyDeviceToHost);
    double mean = 0.0;
    for (int i = 0; i < threads; ++i) mean += (double)host[i];
    mean /= threads;
    printf("{\"run\": \"%s\", \"kernel\": \"parts<%d,%d>\", \"consumer_warpgroups\": %d, "
           "\"cycles_per_tile\": %.1f, \"us_per_tile\": %.5f}\n",
           name, MODE, CONSUMERS, CONSUMERS, mean / iters, ms * 1e3 / iters);
    cudaFree(out);
    cudaFree(cyc);
    return 0;
}

int main(int argc, char** argv) {
    const int iters = argc > 1 ? atoi(argv[1]) : 2000;
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    int bad = 0;
    bad |= run<kS, 1>("S", iters, sms);
    bad |= run<kSoftmax, 1>("softmax", iters, sms);
    bad |= run<kPV, 1>("PV", iters, sms);
    bad |= run<kS | kSoftmax | kPV, 1>("S, softmax, PV", iters, sms);
    bad |= run<kS, 2>("S", iters, sms);
    bad |= run<kSoftmax, 2>("softmax", iters, sms);
    bad |= run<kPV, 2>("PV", iters, sms);
    bad |= run<kS | kSoftmax | kPV, 2>("S, softmax, PV", iters, sms);
    bad |= run<kPipelined, 2>("pipelined", iters, sms);
    bad |= run<kPipelined | kPingPong, 2>("pipelined, ping-pong", iters, sms);
    return bad;
}
"""


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def build(out_dir: Path) -> tuple[Path, dict]:
    """Compile the program; per kernel instance, ptxas's registers and
    spilled bytes."""
    sys.path.insert(0, str(ROOT))
    from accelerate_tpu_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "flash_fwd_parts.cu"
    src.write_text(SOURCE)
    exe = out_dir / "flash_fwd_parts"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run([_build.nvcc_path(), *flags, "-I", str(_build.CSRC), "-o", str(exe),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    usage, current = {}, None
    for line in proc.stderr.splitlines():
        m = re.search(r"Compiling entry function '_Z5partsILi(\d+)ELi(\d+)E", line)
        if m:
            current = f"parts<{m.group(1)},{m.group(2)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and current:
            usage.setdefault(current, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            usage.setdefault(current, {})["registers"] = int(m.group(1))
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    if cuobjdump.is_file() or shutil.which("cuobjdump"):
        sass = subprocess.run([str(cuobjdump) if cuobjdump.is_file() else "cuobjdump", "-sass",
                               str(exe)], capture_output=True, text=True).stdout
        for block in sass.split("Function : ")[1:]:
            m = re.match(r"_Z5partsILi(\d+)ELi(\d+)E", block)
            if m:
                usage.setdefault(f"parts<{m.group(1)},{m.group(2)}>", {})["depbar"] = \
                    block.count("WARPGROUP.DEPBAR")
    return exe, usage


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=2000)
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("time_flash_fwd_parts: no torch", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("time_flash_fwd_parts: no CUDA device", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    exe, usage = build(ROOT / "build" / "flash_fwd_parts")
    proc = subprocess.run([str(exe), str(args.iters)], capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.splitlines():
        rep = json.loads(line)
        rep.update(usage.get(rep["kernel"], {}))
        print(json.dumps(rep), flush=True)
    if proc.returncode != 0:
        print(proc.stderr, file=sys.stderr)
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
