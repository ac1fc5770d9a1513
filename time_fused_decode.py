#!/usr/bin/env python3
"""Where kernels #8 / #9 (the fused LoRA-query paged decode) spend their time.

Run from the root of a checkout on a CUDA card:

    python3 time_fused_decode.py

``fused_bgmv_paged_decode`` (``csrc/paged_decode.cu``) runs #4 / #5's split
page loop after a LoRA prologue that forms each adapter slot's f32 query.
This script times, in a CUDA graph of 20 launches over 4 rotating copies of
the pages (``chip_smoke.time_ms``), on #4's 16-slot decode case at the 600m
attention geometry (``chip_smoke.synthetic_fused_operands``: positions up
to 2047) and on the same operands at short positions (14 live slots at 88
to 540, two dead ones, as a serve's early decode ticks hold them):

- the op with every id 0 (no slot takes the prologue: the page loop alone),
  with ``chip_smoke.LORA_IDS`` (12 of 16 slots adapted) and with every slot
  adapted;
- each of those with the kv heads' blocks of a (slot, chunk) sharing h in
  clusters of up to 8 (``fused_decode_plan``) and with no cluster (every
  block computing the whole h itself);
- #4 / #5 on the base queries, the same pages.

Prints the card, then one JSON line per case, every time in ms.  Over bf16
pages (#8) and int8 pages (#9).  Exits non-zero without a card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# a serve's early decode ticks: prompts of 64-512 tokens and a few new
# tokens; two empty slots
SHORT_POS = [93, 130, 201, 260, 310, 355, 402, 460, 515, 540, -1, -1, 88, 170, 290, 420]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_fused_decode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import flash_attention as fa

    print(cs.card_line(), flush=True)
    _build.build_all(["paged_decode", "lora"])
    ids_cases = {"every id 0": [0] * 16, "LORA_IDS": cs.LORA_IDS,
                 "every slot adapted": [1 + i % cs.LORA["pool_slots"] for i in range(16)]}
    for kv_dtype in ("bf16", cs.QUANT_KV):
        for label, pos in (("16-slot case", None), ("short positions", SHORT_POS)):
            ops = cs.synthetic_fused_operands(torch, kv_dtype)
            if pos is not None:
                ops["pos"] = torch.tensor(pos, dtype=torch.int32, device="cuda")
            pools = [(*ops["pages"], *ops["scales"])] + [
                tuple(t.clone() for t in (*ops["pages"], *ops["scales"])) for _ in range(3)]

            def pages(i):
                kp, vp, *sc = pools[i % len(pools)]
                return (kp, vp), (dict(k_scales=sc[0], v_scales=sc[1]) if sc else {})

            rep = {"kv_dtype": kv_dtype, "operands": label}
            for name, ids in ids_cases.items():
                idt = torch.tensor(ids, dtype=torch.int32, device="cuda")
                args = [ops[k] for k in ("x", "q_base", "a", "b")] + [idt, ops["cos"], ops["sin"]]
                for cap, key in ((fa.FUSED_MAX_CLUSTER, "cluster"), (1, "no cluster")):
                    default, fa.FUSED_MAX_CLUSTER = fa.FUSED_MAX_CLUSTER, cap
                    try:
                        def call(i):
                            (kp, vp), kw = pages(i)
                            return fa.fused_bgmv_paged_decode(*args, kp, vp, ops["bt"],
                                                              ops["pos"], **kw)
                        rep[f"{name}, {key}"] = cs.time_ms(torch, call, graph=True)
                    finally:
                        fa.FUSED_MAX_CLUSTER = default

            def decode(i):
                (kp, vp), kw = pages(i)
                return fa.paged_decode_attention(ops["q_base"], kp, vp, ops["bt"], ops["pos"],
                                                 **kw)
            rep["#4 / #5 on q_base"] = cs.time_ms(torch, decode, graph=True)
            print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
