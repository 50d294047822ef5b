"""LGD core (PyTorch port): LSH-sampled adaptive stochastic gradient estimation.

Chen, Xu & Shrivastava, "LSH-sampling Breaks the Computation
Chicken-and-egg Loop in Adaptive Stochastic Gradient Estimation"
(NeurIPS 2019).
"""

from .families import (  # noqa: F401
    FAMILIES,
    BandedScale,
    LSHFamily,
    NormRangedMIPSFamily,
    family_names,
    get_family,
)
from .simhash import (  # noqa: F401
    LSHParams,
    augment_logistic,
    augment_regression,
    collision_probability,
    collision_probability_quadratic,
    compute_codes,
    logistic_query,
    make_projections,
    probe_masks,
    regression_query,
)
from .tables import (  # noqa: F401
    EMPTY_CODE,
    IndexMutation,
    LSHIndex,
    append_rows,
    band_starts,
    bucket_bounds,
    bucket_bounds_banded,
    bucket_bounds_batched,
    bucket_bounds_multi,
    evict_rows,
    grow_index,
    hash_points,
    mutate_index,
    query_codes,
)
from .sampler import (  # noqa: F401
    GatherBatch,
    SampleDraws,
    SampleResult,
    draw_samples,
    sample,
    sample_batched,
    sample_drain,
    sample_gather,
    sample_gather_batched,
)
from .estimator import (  # noqa: F401
    VarianceReport,
    exact_inclusion_probability,
    empirical_estimator_covariance_trace,
    importance_weights,
    lgd_gradient,
    variance_report,
)
from .lgd import (  # noqa: F401
    LGDProblem,
    LGDState,
    full_loss,
    init,
    lgd_step,
    preprocess_logistic,
    preprocess_logistic_mips,
    preprocess_regression,
    preprocess_regression_mips,
    sgd_step,
)
