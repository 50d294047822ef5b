from .sharding import (  # noqa: F401
    compose_sharded_batch,
    example_shard_bounds,
    shard_store_device,
)
from .multihost import (  # noqa: F401
    BarrierTimeout,
    ClusterError,
    ElasticCluster,
    FileCoord,
    HostLossDetected,
    MultihostConfig,
    StoreCoord,
    backoff_delay,
    shard_adoption_map,
)
