from .synthetic import (  # noqa: F401
    RegressionDataset,
    TokenCorpus,
    make_classification,
    make_regression,
    make_token_corpus,
    uniform_batches,
)
from .health import (  # noqa: F401
    CLUSTER_DEGRADED,
    CLUSTER_HEALTHY,
    CLUSTER_REFORMED,
    HEALTHY,
    STALE_INDEX,
    UNIFORM_FALLBACK,
    ClusterHealthMonitor,
    HealthConfig,
    HealthMonitor,
)
from .lsh_pipeline import (  # noqa: F401
    LSHPipelineConfig,
    LSHSampledPipeline,
    ShardedLSHPipeline,
    lm_head_query_fn,
    mean_pool_feature_fn,
)
