#!/usr/bin/env python3
"""Time the port's bf16 flash_decode at chip_smoke.py's phase-2b row, in
a given checkout, on one CUDA card.

    python3 tools/bench_flash_decode.py [--checkout DIR] [--probe]

DIR (default: this repository) is a checkout whose ``src/repro_torch``
is imported and built, so two commits can be compared on one card by
running this once per checkout.  The row: B 4, Hkv 8, G 3, D 128, cache
2,560 with kv_len [1, 777, 2048, 2560].  The kernel and
scaled_dot_product_attention are timed cold (cycling through
chip_smoke.L2_SETS input sets larger together than the L2) and warm
(one set), with chip_smoke.time_ms.

``--probe`` (a checkout with the split-KV decode) adds, all cold:
  * the serve path's rows: kv_len 2,060-2,063 through the model's
    (B, S_max, Hkv, D) cache, as 5b decodes them;
  * both rows at a sweep of split sizes (the wrapper's ``decode_chunk``
    replaced);
  * the fixed cost: every row at kv_len 1 (one block a row does any
    work), beside a trivial kernel (zeroing 16 floats);
  * the merge: kv_len 96 at 64-key splits (two splits a row).
Prints one JSON line with the card.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNKS = (128, 224, 320, 448)
SERVE_LENS = [2060, 2061, 2062, 2063]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", default=HERE)
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, os.path.join(os.path.abspath(args.checkout), "src"))
    from repro_torch.kernels.flash_attention import flash_decode_cuda
    from repro_torch.kernels.flash_attention import kernel as fk
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    b, hkv, g, d, s = cs.SERVE_B, cs.HKV, cs.GROUP, cs.D_HEAD, cs.CACHE_LENS[-1]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    def lens_of(values):
        return torch.tensor(values, dtype=torch.int32, device=dev)

    def bound_ms(values):
        return (2 * sum(values) * hkv * d + 2 * b * hkv * g * d) * 2 \
            / cs.HBM_RATE * 1e3

    def cold_us(fn, sets):
        return cs.time_ms(torch, cs.rotate(
            [functools.partial(fn, *st) for st in sets]),
            12 * cs.L2_SETS)["ms"] * 1e3

    sets = [(randn(b, hkv, g, d), randn(b, hkv, s, d), randn(b, hkv, s, d))
            for _ in range(cs.L2_SETS)]
    lens = lens_of(cs.CACHE_LENS)
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[:, None,
                                                                  None, :]
    fns = {"kernel": lambda q, k, v: flash_decode_cuda(q, k, v, lens),
           "library": lambda q, k, v: sdpa(q.reshape(b, hkv * g, 1, d), k, v,
                                           attn_mask=mask, enable_gqa=True)}
    out = {"checkout": os.path.abspath(args.checkout),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           "bound_ms": bound_ms(cs.CACHE_LENS)}
    for name, fn in fns.items():
        out[f"{name}_ms"] = cold_us(fn, sets) / 1e3
        out[f"{name}_ms_l2_warm"] = cs.time_ms(
            torch, functools.partial(fn, *sets[0]), 48)["ms"]
    out["bound_share"] = out["bound_ms"] / out["kernel_ms"]

    if args.probe:
        model = [(q, randn(b, s, hkv, d).permute(0, 2, 1, 3),
                  randn(b, s, hkv, d).permute(0, 2, 1, 3))
                 for q, _, _ in sets]
        rows = {"2b": (cs.CACHE_LENS, sets), "serve": (SERVE_LENS, model)}
        planned = fk.decode_chunk(s, b * hkv, fk.sm_count(dev.index or 0))
        out["planned_chunk"] = planned
        out["sweep_us"] = {}
        orig = fk.decode_chunk
        try:
            for chunk in sorted(set(CHUNKS + (planned,))):
                fk.decode_chunk = lambda *_, c=chunk: c
                for tag, (values, use) in rows.items():
                    ln = lens_of(values)
                    us = cold_us(lambda q, k, v: flash_decode_cuda(q, k, v, ln),
                                 use)
                    out["sweep_us"][f"{tag}@{chunk}"] = us
                    out["sweep_us"][f"{tag}@{chunk}_bound_share"] = (
                        bound_ms(values) * 1e3 / us)
            fk.decode_chunk = lambda *_: 64
            two = lens_of([96] * b)
            out["merge2_us"] = cold_us(
                lambda q, k, v: flash_decode_cuda(q, k, v, two), sets)
        finally:
            fk.decode_chunk = orig
        one = lens_of([1] * b)
        out["kv_len1_us"] = cold_us(
            lambda q, k, v: flash_decode_cuda(q, k, v, one), sets)
        z = torch.zeros(16, device=dev)
        out["trivial_kernel_us"] = cs.time_ms(torch, z.zero_, 48)["ms"] * 1e3
    print("bench_flash_decode " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
