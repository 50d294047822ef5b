"""Synthetic datasets (PyTorch port of ``repro.data.synthetic``; no downloads).

``make_regression`` mimics the statistical shape of the paper's
regression datasets (power-law targets, cluster structure);
``make_classification`` is a linearly separable-ish logistic task.
Data are drawn on the device from an explicit ``torch.Generator`` (which
must live on that device), so a full-size training set never crosses
the host.  Torch's stream is not JAX's: the same seed gives the same
distribution as the reference, not the same rows.

The LM token corpus (``make_token_corpus``, ``uniform_batches``) is
numpy from a seed in the reference too, so the port gives the SAME
tokens and batches bitwise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
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


# ---------------------------------------------------------------------------
# LM token corpus
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TokenCorpus:
    """Fixed corpus of examples (n_examples, seq_len+1) with difficulty
    structure: a minority of 'hard' examples drawn from a shifted unigram
    distribution (their loss stays high longer -> larger gradients)."""

    tokens: np.ndarray       # (N, S+1) int32
    hard_mask: np.ndarray    # (N,) bool — ground truth for diagnostics


def make_token_corpus(
    seed: int, n_examples: int, seq_len: int, vocab: int,
    hard_frac: float = 0.1,
) -> TokenCorpus:
    """The reference's corpus, draw for draw (numpy from ``seed``)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    easy = rng.choice(vocab, size=(n_examples, seq_len + 1), p=probs)
    # hard examples: the same zipf structure over a permuted vocabulary —
    # learnable, but rare, so they stay underfit for longer and carry
    # larger gradients (the signal adaptive sampling exploits).
    perm = rng.permutation(vocab)
    hard = perm[rng.choice(vocab, size=(n_examples, seq_len + 1), p=probs)]
    mask = rng.random(n_examples) < hard_frac
    tokens = np.where(mask[:, None], hard, easy).astype(np.int32)
    return TokenCorpus(tokens, mask)


def uniform_batches(corpus: TokenCorpus, batch: int, seed: int = 0,
                    device="cuda") -> Iterator[Dict[str, torch.Tensor]]:
    """Uniformly drawn batches (the non-LGD baseline), the reference's
    index stream from ``seed``; int32 token rows on ``device``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = corpus.tokens.shape[0]
    while True:
        idx = rng.integers(0, n, size=batch)
        chunk = torch.from_numpy(corpus.tokens[idx]).to(device)
        yield {
            "tokens": chunk[:, :-1],
            "targets": chunk[:, 1:],
            "example_ids": torch.from_numpy(idx).to(device),
        }
