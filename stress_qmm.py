#!/usr/bin/env python3
"""Stress kernel #11 (``qmm_tiled``) with several of its blocks on one SM.

Run from the root of a checkout on a CUDA card:

    python3 stress_qmm.py [--source FILE] [--runs N]

The wrapper's plan never launches more blocks than the card has SMs, so
one call of #11 never puts two of its blocks on one SM.  This script calls
the C entry point directly with H split more ways than the plan would
(256 blocks of about 66 KB of shared memory at m 16: three fit on an SM),
``--runs`` times per case, at the 600m dense shapes, and checks every
output against the plain version in f32 and bitwise against the first
run; then the same two calls at once on two streams.  ``--source`` builds
another ``quantized_matmul.cu`` (with the headers beside it) in place of
the checkout's, for an A/B on one card.  Prints one JSON line per case;
exits 1 if any run was off.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (H, F, m, block_m, slices of H)
CASES = [(1536, 4096, 16, 16, 8), (1536, 4096, 64, 64, 8), (1536, 4096, 16, 16, 4),
         (4096, 1536, 16, 16, 8), (1536, 4096, 65, 128, 4), (1536, 4096, 512, 128, 1),
         (4096, 1536, 512, 128, 2), (1576, 768, 37, 64, 7)]


def load(source):
    sys.path.insert(0, str(ROOT))
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import quantized_matmul as qmm

    if source is None:
        lib = ctypes.CDLL(str(_build.build("quantized_matmul")))
    else:
        out = ROOT / "build" / "stress" / "libquantized_matmul.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(source)],
                       check=True, capture_output=True, text=True)
        lib = ctypes.CDLL(str(out))
    lib.qmm_tiled.argtypes, lib.qmm_tiled.restype = qmm._SIGNATURES["qmm_tiled"]
    return lib, qmm


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, default=None)
    parser.add_argument("--runs", type=int, default=60)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("stress_qmm: no CUDA device", file=sys.stderr)
        return 2
    lib, qmm = load(args.source)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = False

    def launch(x, codes, scales, out, partial, counters, block_m, splits, stream):
        err = lib.qmm_tiled(0, x.data_ptr(), codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
                            None if partial is None else partial.data_ptr(), counters.data_ptr(),
                            x.shape[0], x.shape[1], codes.shape[1], 128, block_m, splits, 1,
                            stream.cuda_stream)
        if err:
            raise RuntimeError(f"qmm_tiled failed ({err})")

    for h, f, m, block_m, splits in CASES:
        x = torch.randn(m, h, generator=gen, device=dev).bfloat16()
        codes = torch.randint(-127, 128, (h, f), generator=gen, device=dev).to(torch.int8)
        scales = torch.rand(f // 128, h, generator=gen, device=dev) * 1e-2
        ref = qmm.quantized_matmul_plain(x, codes, scales, qblock=128, out_dtype=torch.float32)
        limit = 1e-3 * ref.abs().max().item()
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        counters = [torch.zeros(256, dtype=torch.int32, device=dev) for _ in streams]
        partials = [torch.empty(splits, m, f, device=dev) if splits > 1 else None
                    for _ in streams]

        def off(out, first):
            return not ((out - ref).abs().max().item() <= limit and torch.equal(out, first))

        first, bad, bad_pair = None, 0, 0
        for _ in range(args.runs):
            out = torch.empty(m, f, device=dev)
            launch(x, codes, scales, out, partials[0], counters[0], block_m, splits,
                   torch.cuda.current_stream())
            torch.cuda.synchronize()
            first = out if first is None else first
            bad += off(out, first)
        for _ in range(args.runs):
            outs = [torch.empty(m, f, device=dev) for _ in streams]
            torch.cuda.synchronize()
            for s, out, partial, cnt in zip(streams, outs, partials, counters):
                launch(x, codes, scales, out, partial, cnt, block_m, splits, s)
            torch.cuda.synchronize()
            bad_pair += off(outs[0], first) or off(outs[1], first)
        clean = all(int(c.abs().sum()) == 0 for c in counters)
        failed |= bool(bad or bad_pair or not clean)
        print(json.dumps({"H": h, "F": f, "m": m, "block_m": block_m, "splits": splits,
                          "blocks": f // 128 * -(-m // block_m) * splits, "runs": args.runs,
                          "runs_off": bad, "two_stream_runs_off": bad_pair,
                          "counters_left_zero": clean}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
