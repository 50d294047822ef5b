#!/usr/bin/env python3
"""Time the LGD step of a given checkout on one CUDA card: chip_smoke.py's
phase 5 trace and phase 4's step times, for comparing the sampler's draw
across commits.

    python3 tools/bench_draw.py [--checkout DIR] [--steps N]

DIR (default: this repository) is a checkout whose ``src/repro_torch``
is imported and built, so two commits can be compared on one card by
running this once per checkout, in turns (parent, change, change,
parent).  For each family of chip_smoke.FAMILIES at multiprobe 0, on
chip_smoke's N 463,715 ``yearmsd-like`` rows (d 91, L 100, K 5, m 16):
``init``, 20 warm-up steps, then ``--steps`` (default 100) ``lgd_step``
and ``sgd_step`` calls each timed on the host clock with a synchronize
(p50, and their ratio), then chip_smoke.profile_steps's torch.profiler
trace of 50 steady LGD steps (wall and device ms a step, device ops a
step, idle share, device ms by kind).  Prints one JSON line with the
card and the kernel launch counts of the timed steps.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkout", default=HERE)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    sys.path.insert(0, os.path.join(os.path.abspath(args.checkout), "src"))
    from repro_torch import kernels
    from repro_torch.core import init, lgd_step, sgd_step
    from repro_torch.data import make_regression
    from repro_torch.kernels import build
    from repro_torch.quickstart import make_problem

    dev = torch.device("cuda")
    kernels.require_full_fp32()
    build.build_all()
    out = {"checkout": os.path.abspath(args.checkout),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip(), "lgd": {}}
    gen = torch.Generator(device=dev).manual_seed(0)
    ds = make_regression(gen, "yearmsd-like", n_train=cs.N_TRAIN, d=90,
                         noise="pareto", device=dev)
    for family in cs.FAMILIES:
        g = torch.Generator(device=dev).manual_seed(2)
        problem, opt = make_problem(family, 0, "sgd")
        state, xt, yt, xa = init(g, problem, ds.x_train, ds.y_train, opt)
        s_lgd = s_sgd = state
        for _ in range(20):
            s_lgd, _ = lgd_step(g, s_lgd, xt, yt, xa, problem, opt)
            s_sgd, _ = sgd_step(g, s_sgd, xt, yt, problem, opt)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t_lgd, t_sgd = [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            s_lgd, _ = lgd_step(g, s_lgd, xt, yt, xa, problem, opt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            s_sgd, _ = sgd_step(g, s_sgd, xt, yt, problem, opt)
            torch.cuda.synchronize()
            t_lgd.append((t1 - t0) * 1e3)
            t_sgd.append((time.perf_counter() - t1) * 1e3)
        row = dict(lgd_step_ms_p50=float(np.median(t_lgd)),
                   sgd_step_ms_p50=float(np.median(t_sgd)),
                   launches={k: v for k, v in kernels.launches.items() if v})
        row["lgd_over_sgd"] = row["lgd_step_ms_p50"] / row["sgd_step_ms_p50"]
        del state, s_lgd, s_sgd, xt, yt, xa
        prof = cs.profile_steps(torch, family, ds, make_problem, init,
                                lgd_step)
        row.update({key: prof.get(key) for key in (
            "wall_ms_per_step", "device_ms_per_step", "device_idle_share",
            "device_ops_per_step", "device_summed_ms_per_step_by_kind")})
        out["lgd"][family] = row
    print("bench_draw " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
