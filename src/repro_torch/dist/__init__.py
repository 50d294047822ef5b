from .sharding import (  # noqa: F401
    compose_sharded_batch,
    example_shard_bounds,
    shard_store_device,
)
