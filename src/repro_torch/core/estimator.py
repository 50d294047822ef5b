"""Unbiased LGD gradient estimator (Theorem 1) + variance diagnostics (Theorem 2).

PyTorch port of ``repro.core.estimator``.  For a single sample x_m drawn
by Algorithm 1 with probability p = cp^K (1-cp^K)^(l-1) / |S_b|,

    Est = grad f(x_m, theta) / (p * N)

satisfies E[Est] = (1/N) sum_i grad f(x_i, theta).  A minibatch of m
independent repetitions averages the m unbiased single-sample estimators.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .families import get_family
from .sampler import SampleResult, popcounts
from .simhash import LSHParams, probe_masks


def importance_weights(res: SampleResult, n_points: int,
                       p_floor: float = 0.0) -> torch.Tensor:
    """w_j = 1 / (p_j * N), optionally clipping tiny p for numerical safety.

    p_floor=0 reproduces the paper exactly; a small floor trades a
    negligible bias for bounded weights on adversarial data.
    """
    p = torch.clamp(res.probs, min=p_floor) if p_floor > 0 else res.probs
    return 1.0 / (p * n_points)


def lgd_gradient(
    grad_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                      torch.Tensor],
    theta: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    res: SampleResult,
    n_points: int,
    p_floor: float = 0.0,
) -> torch.Tensor:
    """Average of per-sample unbiased estimators.

    grad_fn(theta, x, y) -> per-example gradients (m, ...) of the
    gathered sampled rows x (m, d), y (m,) — the reference's per-example
    function with its ``vmap`` written out as a leading batch axis.
    """
    w = importance_weights(res, n_points, p_floor)          # (m,)
    g = grad_fn(theta, x, y)
    return torch.mean(g * w.reshape((-1,) + (1,) * (g.dim() - 1)), dim=0)


def exact_inclusion_probability(
    x_aug: torch.Tensor, query: torch.Tensor, params: LSHParams,
    l=1,
    multiprobe: int = 0,
    band_select: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """p_i = Q_i (1-Q_i)^(l-1) for *all* points (O(N d), analysis only).

    ``Q_i`` is the probability that point i lands in SOME probed bucket
    of one table: ``cp_i^K`` single-probe, the probe-sequence sum of
    the family's probe-class probabilities under multi-probe.
    ``band_select`` (per-point band-selection probability of a banded
    family) multiplies the result; ``None`` for flat families.
    """
    fam = get_family(params.family)
    cp = fam.collision_prob(x_aug, query)
    if multiprobe <= 0:
        q_tab = cp ** params.k
    else:
        rs = popcounts(probe_masks(params.k, 1 + multiprobe), cp.device)
        q_tab = torch.sum(
            fam.probe_class_probs(cp[..., None], params.k, rs), dim=-1)
    p = q_tab * (1.0 - q_tab) ** (
        torch.as_tensor(l, dtype=torch.float32, device=cp.device) - 1.0)
    if band_select is not None:
        p = band_select * p
    return p


class VarianceReport(NamedTuple):
    trace_lgd: torch.Tensor   # Tr(Sigma) of the LGD estimator (Theorem 2)
    trace_sgd: torch.Tensor   # Tr(Sigma) of uniform-sampling SGD
    mean_grad_norm_lgd: torch.Tensor
    mean_grad_norm_sgd: torch.Tensor


def variance_report(
    grad_norms_sq: torch.Tensor,   # (N,) ||grad f(x_i)||_2^2 at current theta
    p_bucket: torch.Tensor,        # (N,) P(x_i in probed bucket) = cp_i^K
    cp_k: torch.Tensor,            # (N,) cp_i^K
    full_grad_norm_sq: torch.Tensor,
) -> VarianceReport:
    """Theorem 2 trace with the paper's Eq. (9) upper-bound approximation
    sum_j p_j / (p_i^2 N) for E|S_b| (as in the reference)."""
    n = grad_norms_sq.shape[0]
    mean_p = torch.mean(cp_k)
    lhs = torch.mean(grad_norms_sq * mean_p
                     / torch.clamp(p_bucket ** 2, min=1e-30))
    trace_lgd = lhs - full_grad_norm_sq / (n * n)
    trace_sgd = torch.mean(grad_norms_sq) - full_grad_norm_sq / (n * n)
    return VarianceReport(
        trace_lgd=trace_lgd,
        trace_sgd=trace_sgd,
        mean_grad_norm_lgd=(torch.sum(grad_norms_sq * p_bucket)
                            / torch.sum(p_bucket)),
        mean_grad_norm_sgd=torch.mean(grad_norms_sq),
    )


def empirical_estimator_covariance_trace(
        estimates: torch.Tensor) -> torch.Tensor:
    """Tr(Cov) of a stack of gradient estimates (trials, d) — for tests."""
    mu = torch.mean(estimates, dim=0, keepdim=True)
    return torch.mean(torch.sum((estimates - mu) ** 2, dim=-1))
