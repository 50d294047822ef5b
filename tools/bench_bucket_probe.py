#!/usr/bin/env python3
"""Time the port's bucket-probe kernels at chip_smoke.py's probe rows, in
a given checkout, on one CUDA card.

    python3 tools/bench_bucket_probe.py [--checkout DIR] [--lgd] [--sweep]

DIR (default: this repository) is a checkout whose ``src/repro_torch``
is imported and built, so two commits can be compared on one card by
running this once per checkout, in turns (parent, change, change,
parent).  The rows, each held against its plain version (lo/hi bitwise
outside near-zero projections) and timed with chip_smoke.time_ms:
  * phase 2's: N 463,715 rows of ``yearmsd-like`` (d 91, L 100, K 5),
    ``bucket_probe`` (J 1), ``bucket_probe_multi`` (J 3) and
    ``bucket_probe_codes`` (quadratic family, J 1 and 3), at B 1 and 16,
    beside two ``torch.searchsorted`` calls;
  * phase 4c's query probe at the train path's shape (d 3,072, K 7,
    L 10, N 2,048; seeded random features, projections and query).
Each row carries the probe kernels' registers and spill bytes from the
checkout's build log.  ``--lgd`` adds phase 5's trace of 50 steady LGD
steps (multiprobe 0) per family: device ms per step, idle share and
the probe's device ms per step.  ``--sweep`` (a checkout with
``probe_plan``) times the hashed rows at every tables-per-block the
launch takes, 1 to 8, and ``--params`` chip_smoke's J 1 comparison of
the masks' parameter blocks, at B 1 of phase 2.  Prints one JSON line
with the card.
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
    ap.add_argument("--lgd", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--params", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, os.path.join(os.path.abspath(args.checkout), "src"))
    from repro_torch import kernels
    from repro_torch.core import (
        IndexMutation, compute_codes, init, lgd_step, mutate_index,
        probe_masks, regression_query)
    from repro_torch.data import make_regression
    from repro_torch.kernels import build
    from repro_torch.kernels.bucket_probe import (
        bucket_probe_codes_cuda, bucket_probe_codes_ref, bucket_probe_cuda,
        bucket_probe_multi_cuda, bucket_probe_multi_ref, bucket_probe_ref)
    from repro_torch.kernels.simhash import simhash_codes_ref
    from repro_torch.quickstart import make_problem

    dev = torch.device("cuda")
    kernels.require_full_fp32()
    build.build_all()
    use = {}
    for fn_name, u in build.ptxas_usage(build.build_log(
            "bucket_probe")).items():
        for kname in ("probe_hashed_kernel", "probe_codes_kernel"):
            if kname in fn_name:
                use[kname] = dict(regs=u["registers"], spill=u["spill_stores"]
                                  + u["spill_loads"])
    out = {"checkout": os.path.abspath(args.checkout),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(),
           "ptxas": use, "rows": []}

    def two_searches(codes_lb, sorted_codes):
        return (torch.searchsorted(sorted_codes, codes_lb, side="left",
                                   out_int32=True),
                torch.searchsorted(sorted_codes, codes_lb, side="right",
                                   out_int32=True))

    def row(name, tag, kernel, plain, library, near=None):
        got, want = kernel(), plain()
        for a, c in zip(got, want):
            keep = slice(None) if near is None else ~near.expand(a.shape)
            if not torch.equal(a[keep], c[keep]):
                sys.exit(f"{name} {tag}: kernel disagrees with its plain "
                         "version")
        r = {"name": name, "shape": tag}
        for key, fn in (("ms", kernel), ("plain_ms", plain),
                        ("library_ms", library)):
            tm = cs.time_ms(torch, fn, 100)
            r[key] = tm["ms"]
            r[key.replace("ms", "loop_ms")] = tm["loop_ms"]
        out["rows"].append(r)

    def sweep(tag, call, l, k):
        """Device ms of ``call`` at each tables-per-block the launch takes."""
        if not args.sweep:
            return
        from repro_torch.kernels.bucket_probe import kernel as bk
        orig, res = bk.probe_plan, {}
        try:
            for tables in (1, 2, 4, 8):
                if tables <= min(l, bk.THREADS // k):
                    bk.probe_plan = lambda *a, t=tables: (t, orig(*a)[1])
                    res[tables] = cs.time_ms(torch, call, 100)["ms"]
        finally:
            bk.probe_plan = orig
        out.setdefault("sweep", {})[tag] = res

    def near_of(q, w, l, k, j=1):
        return ((q @ w).abs() < 1e-4).reshape(q.shape[0], 1, l, k).any(
            -1).expand(q.shape[0], j, l)

    # phase 2's inputs
    gen = torch.Generator(device=dev).manual_seed(0)
    ds = make_regression(gen, "yearmsd-like", n_train=cs.N_TRAIN, d=90,
                         noise="pareto", device=dev)
    prob_srp, _ = make_problem("srp", 0, "sgd")
    _, _, x_aug = prob_srp.preprocess(ds.x_train, ds.y_train)
    p_lin = prob_srp.lsh
    d, l, k = x_aug.shape[1], p_lin.l, p_lin.k
    idx_lin = mutate_index(None, IndexMutation("build", generator=gen,
                                               x_aug=x_aug), p_lin)
    w, sc = idx_lin.projections, idx_lin.sorted_codes
    prob_q, _ = make_problem("quadratic", 0, "sgd")
    idx_q = mutate_index(None, IndexMutation("build", generator=gen,
                                             x_aug=x_aug), prob_q.lsh)
    masks3 = probe_masks(k, 3)
    marr = torch.tensor(masks3, dtype=torch.int64, device=dev)
    for b in (1, 16):
        q = regression_query(0.1 * torch.randn(
            (b, d - 1), generator=gen, device=dev)).contiguous()
        qt = compute_codes(q, w, k=k, l=l).T.contiguous()
        near = near_of(q, w, l, k)
        row("bucket_probe", f"B {b}, J 1",
            lambda: tuple(t[:, None] for t in bucket_probe_cuda(
                q, w, sc, k=k, l=l)),
            lambda: tuple(t[:, None] for t in bucket_probe_ref(
                q, w, sc, k=k, l=l)),
            lambda: two_searches(qt, sc), near)
        pt = (qt.T[:, None, :] ^ marr[None, :, None]).reshape(
            b * 3, l).T.contiguous()
        row("bucket_probe_multi", f"B {b}, J 3",
            lambda: bucket_probe_multi_cuda(q, w, sc, masks3, k=k, l=l),
            lambda: bucket_probe_multi_ref(q, w, sc, masks3, k=k, l=l),
            lambda: two_searches(pt, sc), near.expand(b, 3, l))
        sweep(f"bucket_probe B {b}, J 1",
              lambda: bucket_probe_cuda(q, w, sc, k=k, l=l), l, k)
        sweep(f"bucket_probe_multi B {b}, J 3",
              lambda: bucket_probe_multi_cuda(q, w, sc, masks3, k=k, l=l),
              l, k)
        if args.params and b == 1:
            from repro_torch.kernels.bucket_probe import kernel as bk
            out["j1_params"] = cs.time_param_blocks(
                torch, bk, lambda: bucket_probe_multi_cuda(
                    q, w, sc, (0,), k=k, l=l), pairs=12)
        qq = compute_codes(q, idx_q.projections, k=k, l=l, quadratic=True)
        for j in (1, 3):
            pc = (qq[:, None, :] ^ marr[None, :j, None]).reshape(
                b * j, l).contiguous()
            pct = pc.T.contiguous()
            row("bucket_probe_codes", f"B {b}, J {j}",
                lambda: bucket_probe_codes_cuda(pc, idx_q.sorted_codes),
                lambda: bucket_probe_codes_ref(pc, idx_q.sorted_codes),
                lambda: two_searches(pct, idx_q.sorted_codes))
    del idx_lin, idx_q, w, sc

    # phase 4c's query probe at the train path's shape
    gt = torch.Generator(device=dev).manual_seed(11)
    n_t, d_t, k_t, l_t = cs.TRAIN_CORPUS, 3072, 7, 10
    shift = torch.linspace(0, 2, d_t, device=dev)
    x_t = torch.randn((n_t, d_t), generator=gt, device=dev) + shift
    w_t = torch.randn((d_t, l_t * k_t), generator=gt, device=dev)
    sc_t = torch.sort(simhash_codes_ref(x_t, w_t, k=k_t, l=l_t).T.contiguous(),
                      dim=1).values
    q_t = (torch.randn((1, d_t), generator=gt, device=dev) + shift)
    qc_t = compute_codes(q_t, w_t, k=k_t, l=l_t).T.contiguous()
    row("bucket_probe", f"B 1, d {d_t}, K {k_t}, L {l_t}, N {n_t}",
        lambda: tuple(t[:, None] for t in bucket_probe_cuda(
            q_t, w_t, sc_t, k=k_t, l=l_t)),
        lambda: tuple(t[:, None] for t in bucket_probe_ref(
            q_t, w_t, sc_t, k=k_t, l=l_t)),
        lambda: two_searches(qc_t, sc_t), near_of(q_t, w_t, l_t, k_t))
    sweep(f"bucket_probe B 1, d {d_t}",
          lambda: bucket_probe_cuda(q_t, w_t, sc_t, k=k_t, l=l_t), l_t, k_t)
    for r in out["rows"]:
        r.update(use.get("probe_codes_kernel" if r["name"] ==
                         "bucket_probe_codes" else "probe_hashed_kernel", {}))

    if args.lgd:
        out["lgd"] = {}
        for family in cs.FAMILIES:
            prof = cs.profile_steps(torch, family, ds, make_problem, init,
                                    lgd_step)
            out["lgd"][family] = {key: prof.get(key) for key in (
                "device_ms_per_step", "device_idle_share",
                "device_ops_per_step", "wall_ms_per_step")}
            # a steady step's only hand-written kernel is its probe
            out["lgd"][family]["probe_ms_per_step"] = prof.get(
                "device_summed_ms_per_step_by_kind", {}).get("hand-written")
    print("bench_bucket_probe " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
