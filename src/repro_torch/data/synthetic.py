"""Synthetic datasets (PyTorch port of ``repro.data.synthetic``; no downloads).

``make_regression`` mimics the statistical shape of the paper's
regression datasets (power-law targets, cluster structure);
``make_classification`` is a linearly separable-ish logistic task.
Data are drawn on the device from an explicit ``torch.Generator`` (which
must live on that device), so a full-size training set never crosses
the host.  Torch's stream is not JAX's: the same seed gives the same
distribution as the reference, not the same rows.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import resolve_device


@dataclasses.dataclass(frozen=True)
class RegressionDataset:
    name: str
    x_train: torch.Tensor
    y_train: torch.Tensor
    x_test: torch.Tensor
    y_test: torch.Tensor


def make_regression(
    generator: torch.Generator,
    name: str = "yearmsd-like",
    n_train: int = 40_000,
    n_test: int = 5_000,
    d: int = 90,
    noise: str = "pareto",       # pareto | gauss | clustered
    device="cuda",
) -> RegressionDataset:
    device = resolve_device(device)
    g = dict(generator=generator, device=device)
    n = n_train + n_test
    if noise == "clustered":
        centers = torch.randn((16, d), **g) * 2.0
        assign = torch.randint(0, 16, (n,), **g)
        x = centers[assign] + 0.5 * torch.randn((n, d), **g)
    else:
        x = torch.randn((n, d), **g)
    theta = torch.randn((d,), **g)
    y = x @ theta
    if noise == "pareto":
        # alpha=1.2 power-law residuals (YearMSD-like skew), the regime
        # Lemma 1 targets: pareto = exp(Exponential(1) / alpha)
        e = torch.empty((n,), device=device).exponential_(generator=generator)
        sign = torch.randint(0, 2, (n,), **g).to(torch.float32) * 2.0 - 1.0
        y = y + torch.exp(e / 1.2) * sign
    elif noise == "gauss":
        y = y + 0.5 * torch.randn((n,), **g)
    elif noise == "clustered":
        hard = (assign >= 13).to(torch.float32)
        y = y + hard * 8.0 * torch.sign(torch.randn((n,), **g))
    else:
        raise ValueError(f"unknown noise {noise!r}")
    return RegressionDataset(
        name, x[:n_train], y[:n_train], x[n_train:], y[n_train:])


def make_classification(
    generator: torch.Generator, n_train: int = 20_000, n_test: int = 2_000,
    d: int = 64, device="cuda",
) -> RegressionDataset:
    device = resolve_device(device)
    g = dict(generator=generator, device=device)
    n = n_train + n_test
    x = torch.randn((n, d), **g)
    theta = torch.randn((d,), **g)
    y = torch.sign(x @ theta + 0.1)
    return RegressionDataset(
        "synthetic-logistic", x[:n_train], y[:n_train], x[n_train:],
        y[n_train:])
