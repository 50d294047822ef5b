"""Quickstart: LGD (LSH-sampled gradient descent) vs plain SGD on least squares.

The PyTorch twin of ``examples/quickstart.py``, the paper's core
experiment:
  1. build hash tables over [x_i, y_i]  (one-time cost)
  2. per step: hash-lookup sample -> unbiased gradient -> optimiser update
  3. compare convergence against uniform-sampling SGD

Runs on the card (the simhash and bucket-probe kernels) unless
``--device cpu`` asks for the plain PyTorch path.  The data are the
``yearmsd-like`` generator's rows; ``--n-train 463715`` is the size of
the public YearPredictionMSD train split.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--steps 600]
          [--optimizer sgd] [--multiprobe 2] [--family mips]
          [--n-train 8000] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import (
    LGDProblem, LSHParams, full_loss, get_family, init, lgd_step, sgd_step,
)
from repro_torch.data import make_regression
from repro_torch.kernels import resolve_device
from repro_torch.optim import make_optimizer


D_RAW = 90   # YearPredictionMSD's feature count


def make_problem(family: str, multiprobe: int, optimizer: str):
    """The quickstart's LGD problem and optimiser for a family."""
    # augmented-vector dim: [x, y] is d+1; asymmetric families append
    # their extra coordinate on top
    dim = get_family(family).aug_dim(D_RAW + 1)
    problem = LGDProblem(
        kind="regression",
        lsh=LSHParams(k=5, l=100, dim=dim, family=family),
        minibatch=16,
        multiprobe=multiprobe,
        # the MIPS family trains on UN-normalised rows: bound the rare
        # tiny-p draws
        p_floor=1e-7 if family in ("mips", "mips_banded") else 0.0,
    )
    lr = 5e-2 if optimizer != "adam" else 5e-3
    if family in ("mips", "mips_banded"):
        # un-normalised rows: ||x_i||^2 ~ d instead of 1, so the stable
        # LR of the quadratic loss scales by ~1/d
        lr /= D_RAW
    return problem, make_optimizer(optimizer, lr)


def setup(family: str = "quadratic", multiprobe: int = 0,
          optimizer: str = "sgd", n_train: int = 8000, device="cuda"):
    """Data, problem, optimiser and initial state of the quickstart run.

    Returns (problem, opt, state, x_train, y_train, x_aug, generator)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    ds = make_regression(gen, "yearmsd-like", n_train=n_train, d=D_RAW,
                         noise="pareto", device=device)
    problem, opt = make_problem(family, multiprobe, optimizer)
    state, xt, yt, x_aug = init(gen, problem, ds.x_train, ds.y_train, opt)
    return problem, opt, state, xt, yt, x_aug, gen


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600,
                    help="training steps (600 reproduces the paper curve; "
                         "use ~60 for a smoke run)")
    ap.add_argument("--optimizer", default="sgd",
                    choices=["sgd", "momentum", "adagrad", "adam"],
                    help="optimiser under BOTH estimators")
    ap.add_argument("--multiprobe", type=int, default=0,
                    help="extra Hamming-ball probe codes per table")
    ap.add_argument("--family", default="quadratic",
                    choices=["quadratic", "srp", "mips", "mips_banded"],
                    help="LSH family: quadratic matches |<q,x>|; srp is "
                         "cosine SimHash; mips is the asymmetric "
                         "no-normalisation Simple-LSH; mips_banded its "
                         "norm-ranged (banded) variant")
    ap.add_argument("--n-train", type=int, default=8000,
                    help="training rows (463715 = YearPredictionMSD train)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (plain PyTorch)")
    args = ap.parse_args(argv)

    problem, opt, state, xt, yt, x_aug, gen = setup(
        args.family, args.multiprobe, args.optimizer, args.n_train,
        args.device)
    print(f"dataset: {tuple(xt.shape)}, hash tables: "
          f"{tuple(state.index.sorted_codes.shape)} (K={problem.lsh.k}, "
          f"L={problem.lsh.l}), family: {args.family}, "
          f"optimizer: {args.optimizer}, device: {xt.device}")

    history = {"step": [], "lgd": [], "sgd": []}
    s_lgd = s_sgd = state
    for step in range(args.steps + 1):
        s_lgd, m = lgd_step(gen, s_lgd, xt, yt, x_aug, problem, opt)
        s_sgd, _ = sgd_step(gen, s_sgd, xt, yt, problem, opt)
        if step % max(args.steps // 6, 1) == 0:
            lgd = float(full_loss(s_lgd.theta, xt, yt, problem))
            sgd = float(full_loss(s_sgd.theta, xt, yt, problem))
            history["step"].append(step)
            history["lgd"].append(lgd)
            history["sgd"].append(sgd)
            print(f"step {step:4d}  LGD loss {lgd:.4f}  SGD loss {sgd:.4f}  "
                  f"(bucket={float(m['bucket_size_mean']):.0f}, "
                  f"probes={float(m['n_probes_mean']):.1f}, "
                  f"fallback={float(m['fallback_frac']):.2f})")
    return history


if __name__ == "__main__":
    main()
