"""Distribution substrate: logical-axis sharding state, the async fabric,
elastic resize, and the sharded DMA serving layer (DESIGN.md §6, §10)."""
from .shardlib import (  # noqa: F401
    Mesh,
    axis_size,
    clear_mesh,
    current_mesh,
    current_rules,
    logical_spec,
    set_mesh,
    set_rules,
    shard,
    use_mesh,
)
from .fabric import (  # noqa: F401
    AsyncFabric,
    FabricLink,
    FabricTicket,
    RebalancePlanner,
)
from .sharded_runtime import (  # noqa: F401
    MigrationStats,
    PageOwnerMap,
    ShardedDMARuntime,
    ShardedKVPool,
    ShardedServeEngine,
    resolve_num_shards,
)
from .fault import (  # noqa: F401
    reshard_checkpoint,
    survive_shrink,
    ungraceful_resize,
)
