#!/usr/bin/env python3
"""Time the port's SimHash kernel at chip_smoke.py's rows, in a given
checkout, on one CUDA card.

    python3 tools/bench_simhash.py [--checkout DIR] [--sweep]

DIR (default: this repository) is a checkout whose ``src/repro_torch``
is imported and built, so two commits can be compared on one card by
running this once per checkout, in turns (parent, change, change,
parent).  The rows, each held against its plain version (codes equal
outside near-zero projections) and timed with chip_smoke.time_ms:
  * phase 2's: N 463,715 rows of ``yearmsd-like`` (d 91, L 100, K 5)
    and the projections of an index build;
  * phase 4c's at the train path's shape (d 3,072, K 7, L 10, N 2,048;
    seeded random features and projections);
  * tests/test_torch_cuda.py's slice widths (N 3,000, d 91) and K 32
    with a ragged row tile (N 777, d 40, L 7).
Each row carries its bound (chip_smoke's: 2·N·d·L·K fp32 operations
against x, w and the codes' bytes), ``projection_matmul_ms`` (``x @ w``
through torch.matmul in full fp32: a yardstick, not the same function)
and, for a checkout with ``simhash_plan``, the plan and its
instantiation's registers, spills and shared memory from the build log.
``--sweep`` times each row under every plan the kernel takes (rows a
block; above 128 features, the blocks that share a row tile: one, the
parts in registers, or split over 2 to 16 blocks, in the wide or the
narrow column layout), each checked to give the default plan's bits.
Prints one JSON line with the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", default=HERE)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, os.path.join(os.path.abspath(args.checkout), "src"))
    from repro_torch import kernels
    from repro_torch.core import IndexMutation, mutate_index
    from repro_torch.data import make_regression
    from repro_torch.kernels import build
    from repro_torch.kernels.simhash import kernel as sk
    from repro_torch.kernels.simhash import (
        simhash_codes_cuda, simhash_codes_ref)
    from repro_torch.quickstart import make_problem

    dev = torch.device("cuda")
    kernels.require_full_fp32()
    build.build_all()
    usage = cs.simhash_usage(build)
    planned = getattr(sk, "simhash_plan", None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"checkout": os.path.abspath(args.checkout),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           "ptxas": usage, "rows": []}

    def row(tag, x, w, l, k, reps):
        n, d = x.shape
        got = simhash_codes_cuda(x, w, k=k, l=l)
        want = simhash_codes_ref(x, w, k=k, l=l).T
        near = ((x @ w).abs() < 1e-4).reshape(n, l, k).any(-1).T
        if not torch.equal(got[~near], want[~near]):
            sys.exit(f"simhash {tag}: kernel disagrees with its plain version")
        nb, fl = cs.bound(n * d * 4 + d * l * k * 4 + n * l * 8,
                          2.0 * n * d * l * k)
        r = {"shape": tag, "bound_ms": nb, "bound_by": fl}
        for key, fn in (("ms", lambda: simhash_codes_cuda(x, w, k=k, l=l)),
                        ("plain_ms", lambda: simhash_codes_ref(x, w, k=k,
                                                               l=l)),
                        ("projection_matmul_ms", lambda: x @ w)):
            tm = cs.time_ms(torch, fn, reps)
            r[key] = tm["ms"]
            r[key.replace("ms", "loop_ms")] = tm["loop_ms"]
        r["bound_share"] = nb / r["ms"]
        if planned:
            plan = planned(n, d, l, k, sms)
            inst = sk.simhash_instance(x, plan, l, k)
            r.update(plan=plan._asdict(), instance=cs.simhash_label(inst),
                     **usage.get(cs.simhash_label(inst), {}),
                     dynamic_smem=inst["smem"])
            if args.sweep:
                r["sweep"] = sweep(x, w, l, k, reps, got)
        out["rows"].append(r)

    def sweep(x, w, l, k, reps, want):
        """Device ms under every plan the kernel takes; all give the same
        bits (one sum order)."""
        n, d = x.shape
        base = planned(n, d, l, k, sms)
        res = {}
        try:
            for bm in sorted(set(sk.ROWS) | set(sk.NARROW_ROWS)):
                for ranks in (1, 2, 4, 8, 16):
                    for narrow in (False, True):
                        plan = base._replace(bm=bm, ranks=ranks,
                                             tiles=-(-n // bm), narrow=narrow)
                        inst = sk.simhash_instance(x, plan, l, k)
                        if inst is None or (
                                plan.scratch_floats * 4 > sk.SCRATCH_CAP
                                or plan.split and plan.blocks
                                > sk.BLOCKS_PER_SM * sms):
                            continue
                        tag = f"{cs.simhash_label(inst)}, ranks {ranks}"
                        sk.simhash_plan = lambda *a, p=plan: p
                        fn = lambda: simhash_codes_cuda(x, w, k=k, l=l)
                        if not torch.equal(fn(), want):
                            sys.exit(f"{tag} changes the codes")
                        res[tag] = cs.time_ms(torch, fn, reps)["ms"]
        finally:
            sk.simhash_plan = planned
        return res

    # phase 2's inputs
    gen = torch.Generator(device=dev).manual_seed(0)
    ds = make_regression(gen, "yearmsd-like", n_train=cs.N_TRAIN, d=90,
                         noise="pareto", device=dev)
    prob_srp, _ = make_problem("srp", 0, "sgd")
    _, _, x_aug = prob_srp.preprocess(ds.x_train, ds.y_train)
    p_lin = prob_srp.lsh
    idx = mutate_index(None, IndexMutation("build", generator=gen,
                                           x_aug=x_aug), p_lin)
    row(f"N {x_aug.shape[0]}, d {x_aug.shape[1]}, L {p_lin.l}, K {p_lin.k}",
        x_aug, idx.projections, p_lin.l, p_lin.k, 10)
    del idx, ds, x_aug

    def seeded(seed, n, d, l, k):
        g = torch.Generator(device=dev).manual_seed(seed)
        shift = torch.linspace(0, 2, d, device=dev)
        return (torch.randn((n, d), generator=g, device=dev) + shift,
                torch.randn((d, l * k), generator=g, device=dev))

    for seed, (n, d, l, k) in enumerate([(cs.TRAIN_CORPUS, 3072, 10, 7),
                                         (3000, 91, 100, 5),
                                         (777, 40, 7, 32)]):
        x, w = seeded(11 + seed, n, d, l, k)
        row(f"N {n}, d {d}, L {l}, K {k}", x, w, l, k, 100)
    print("bench_simhash " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
