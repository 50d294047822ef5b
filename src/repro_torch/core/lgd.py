"""LGD (Algorithm 2): LSH-sampled gradient descent for linear models.

PyTorch port of ``repro.core.lgd``:
  * least-squares regression   — hash [x_i, y_i], query [theta, -1]
  * logistic regression        — hash y_i * x_i, query -theta
  * any first-order optimiser  — LGD only replaces the gradient estimator.

Each workload (kind) supplies its base vector, base query and
per-example loss; the hash family supplies augmentation and the
collision law.  Symmetric families see rows centred and scaled to unit
L2 norm (Sec. 2.2); the asymmetric ``mips`` family drops that and
hashes raw rows through its Simple-LSH augmentation.

Losses and gradients are written for a leading batch axis (the
reference's per-example functions with their ``vmap`` written out); the
same function serves one row or many.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from . import estimator as est
from .families import get_family
from .sampler import (
    SampleDraws,
    SampleResult,
    sample,
    sample_batched,
    sample_drain,
)
from .simhash import (
    LSHParams,
    augment_logistic,
    logistic_query,
    regression_query,
)
from .tables import IndexMutation, LSHIndex, mutate_index


# ---------------------------------------------------------------------------
# preprocessing (Sec. 2.2)
# ---------------------------------------------------------------------------

def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-30)


def _standardise(y: torch.Tensor) -> torch.Tensor:
    # population std (ddof=0), as jnp.std
    return (y - torch.mean(y)) / torch.clamp(
        torch.std(y, correction=0), min=1e-30)


def preprocess_regression(x: torch.Tensor, y: torch.Tensor):
    """Centre features + unit-norm x rows; standardise y globally.

    With unit-norm x_i the optimal weight is |[theta,-1].[x_i, y_i]|
    (Eq. 4), so the stored vector is x_aug_i = [x_i, y_i].  y is scaled
    *globally* so heavy-tailed targets keep heavy-tailed gradients.

    Returns (x', y', x_aug).
    """
    x = _unit_rows(x - torch.mean(x, dim=0, keepdim=True))
    y = _standardise(y)
    return x, y, torch.cat([x, y[:, None]], dim=-1)


def preprocess_logistic(x: torch.Tensor, y: torch.Tensor):
    """Centre + row-normalise x; labels in {-1,+1}. Hash rows y_i * x_i."""
    x = _unit_rows(x - torch.mean(x, dim=0, keepdim=True))
    return x, y, augment_logistic(x, y)


def preprocess_regression_mips(x: torch.Tensor, y: torch.Tensor, family):
    """No-normalisation regression preprocessing for asymmetric families:
    centre x, standardise y globally, augment the raw [x_i, y_i] rows."""
    x = x - torch.mean(x, dim=0, keepdim=True)
    y = _standardise(y)
    return x, y, family.augment_data(torch.cat([x, y[:, None]], dim=-1))


def preprocess_logistic_mips(x: torch.Tensor, y: torch.Tensor, family):
    """Centre x only; hash the raw y_i * x_i rows via the family."""
    x = x - torch.mean(x, dim=0, keepdim=True)
    return x, y, family.augment_data(x * y[..., None])


# ---------------------------------------------------------------------------
# per-example losses / gradients (leading batch axis optional)
# ---------------------------------------------------------------------------

def squared_loss(theta, x, y):
    r = x @ theta - y
    return r * r


def squared_loss_grad(theta, x, y):
    return (2.0 * (x @ theta - y))[..., None] * x


def logistic_loss(theta, x, y):
    return torch.log1p(torch.exp(-y * (x @ theta)))


def logistic_loss_grad(theta, x, y):
    z = y * (x @ theta)
    return (-y * torch.sigmoid(-z))[..., None] * x


# ---------------------------------------------------------------------------
# LGD problem + state
# ---------------------------------------------------------------------------

_KINDS = {
    "regression": dict(
        base_query=regression_query,
        loss=squared_loss, grad=squared_loss_grad,
        preprocess=preprocess_regression,
        preprocess_asym=preprocess_regression_mips),
    "logistic": dict(
        base_query=logistic_query,
        loss=logistic_loss, grad=logistic_loss_grad,
        preprocess=preprocess_logistic,
        preprocess_asym=preprocess_logistic_mips),
}


@dataclasses.dataclass(frozen=True)
class LGDProblem:
    """Static description of an LGD-trainable linear model."""

    kind: str                      # "regression" | "logistic"
    lsh: LSHParams
    minibatch: int = 1
    p_floor: float = 0.0
    drain: bool = False            # Appendix B.2 bucket-draining minibatch
    query_jitter: float = 0.0      # >0: one perturbed query per repetition,
    #                                probed as one batched kernel launch
    multiprobe: int = 0            # extra Hamming-ball probe codes per table

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; "
                             f"kinds: {sorted(_KINDS)}")
        if self.query_jitter > 0.0 and self.drain:
            raise ValueError(
                "query_jitter requires per-repetition queries; drain mode "
                "draws the whole minibatch from one query's bucket")
        if self.multiprobe > 0 and self.drain:
            raise ValueError(
                "multiprobe is not supported in drain mode: the drained "
                "bucket belongs to ONE (table, code) pair (Appendix B.2)")

    @property
    def family(self):
        return get_family(self.lsh.family)

    def query_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """theta -> hashed query (asymmetric families augment it)."""
        base = _KINDS[self.kind]["base_query"]
        fam = self.family
        if fam.asymmetric:
            return lambda theta: fam.augment_query(base(theta))
        return base

    def preprocess(self, x: torch.Tensor, y: torch.Tensor):
        """(x, y) -> (x_train, y_train, x_aug) for this kind + family."""
        kind = _KINDS[self.kind]
        if self.family.asymmetric:
            return kind["preprocess_asym"](x, y, self.family)
        return kind["preprocess"](x, y)

    def grad_fn(self):
        return _KINDS[self.kind]["grad"]

    def loss_fn(self):
        return _KINDS[self.kind]["loss"]


class LGDState(NamedTuple):
    theta: torch.Tensor
    opt_state: tuple
    index: LSHIndex
    step: torch.Tensor


def init(
    generator: Optional[torch.Generator],
    problem: LGDProblem,
    x: torch.Tensor,
    y: torch.Tensor,
    optimizer,
    theta0: Optional[torch.Tensor] = None,
    projections: Optional[torch.Tensor] = None,
):
    """Preprocess data, build hash tables (one-time cost), init optimiser.

    Runs on the device of ``x`` (the kernels on a card); ``generator``
    draws the projections unless ``projections`` are given.
    Returns (state, x_train, y_train, x_aug).
    """
    xt, yt, x_aug = problem.preprocess(x, y)
    index = mutate_index(
        None, IndexMutation("build", generator=generator,
                            projections=projections, x_aug=x_aug),
        problem.lsh)
    theta = (theta0 if theta0 is not None else
             torch.zeros(xt.shape[1], dtype=torch.float32, device=x.device))
    step = torch.zeros((), dtype=torch.int32, device=x.device)
    return LGDState(theta, optimizer.init(theta), index, step), xt, yt, x_aug


def lgd_step(
    generator: Optional[torch.Generator],
    state: LGDState,
    x: torch.Tensor,
    y: torch.Tensor,
    x_aug: torch.Tensor,
    problem: LGDProblem,
    optimizer,
    draws: Optional[SampleDraws] = None,
    jitter: Optional[torch.Tensor] = None,
) -> Tuple[LGDState, dict]:
    """One LGD iteration: hash-lookup sample -> unbiased grad -> optimiser.

    ``draws`` (and, with ``query_jitter``, the (minibatch, d) standard
    normal ``jitter``) replace the generator's draws when given.
    """
    query = problem.query_fn()(state.theta)
    if problem.query_jitter > 0.0:
        if jitter is None:
            jitter = torch.randn((problem.minibatch,) + query.shape,
                                 generator=generator, device=query.device)
        queries = query[None] + problem.query_jitter * jitter
        res = sample_batched(generator, state.index, x_aug, queries,
                             problem.lsh, m=1, multiprobe=problem.multiprobe,
                             draws=draws)
        res = SampleResult(*(a[:, 0] for a in res))      # (B, 1) -> (B,)
    elif problem.drain:
        res = sample_drain(generator, state.index, x_aug, query, problem.lsh,
                           m=problem.minibatch, draws=draws)
    else:
        res = sample(generator, state.index, x_aug, query, problem.lsh,
                     m=problem.minibatch, multiprobe=problem.multiprobe,
                     draws=draws)
    xb, yb = x[res.indices], y[res.indices]
    grad = est.lgd_gradient(problem.grad_fn(), state.theta, xb, yb, res,
                            n_points=x.shape[0], p_floor=problem.p_floor)
    updates, opt_state = optimizer.update(grad, state.opt_state, state.theta)
    metrics = {
        "sample_prob_mean": torch.mean(res.probs),
        "n_probes_mean": torch.mean(res.n_probes.to(torch.float32)),
        "bucket_size_mean": torch.mean(res.bucket_sizes.to(torch.float32)),
        "fallback_frac": torch.mean(res.fallback.to(torch.float32)),
        "primary_miss_frac": torch.mean(
            (res.probe_code != 0).to(torch.float32)),
        "grad_norm": torch.linalg.vector_norm(grad),
    }
    return LGDState(state.theta + updates, opt_state, state.index,
                    state.step + 1), metrics


def sgd_step(
    generator: Optional[torch.Generator],
    state: LGDState,
    x: torch.Tensor,
    y: torch.Tensor,
    problem: LGDProblem,
    optimizer,
    indices: Optional[torch.Tensor] = None,
) -> Tuple[LGDState, dict]:
    """Uniform-sampling baseline with the same optimiser (the paper's SGD);
    ``indices`` (minibatch,) replace the generator's draw when given."""
    if indices is None:
        indices = torch.randint(0, x.shape[0], (problem.minibatch,),
                                generator=generator, device=x.device)
    grad = torch.mean(problem.grad_fn()(state.theta, x[indices], y[indices]),
                      dim=0)
    updates, opt_state = optimizer.update(grad, state.opt_state, state.theta)
    return (
        LGDState(state.theta + updates, opt_state, state.index,
                 state.step + 1),
        {"grad_norm": torch.linalg.vector_norm(grad)},
    )


def full_loss(theta, x, y, problem: LGDProblem):
    return torch.mean(problem.loss_fn()(theta, x, y))
