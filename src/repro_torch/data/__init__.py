from .synthetic import (  # noqa: F401
    RegressionDataset,
    TokenCorpus,
    make_classification,
    make_regression,
    make_token_corpus,
    uniform_batches,
)
from .health import (  # noqa: F401
    HEALTHY,
    STALE_INDEX,
    UNIFORM_FALLBACK,
    HealthConfig,
    HealthMonitor,
)
from .lsh_pipeline import (  # noqa: F401
    LSHPipelineConfig,
    LSHSampledPipeline,
    lm_head_query_fn,
    mean_pool_feature_fn,
)
