"""Core library: the paper's DMAC as a composable descriptor subsystem."""
from .descriptor import (  # noqa: F401
    DESCRIPTOR_BYTES,
    END_OF_CHAIN,
    DescriptorArray,
    from_bytes,
    from_packed,
    is_done_packed,
    mark_done_packed,
    pack,
    to_bytes,
    to_packed,
)
from .chain import (  # noqa: F401
    concat_chains,
    flatten_chain,
    from_gather,
    from_pages,
    from_scatter,
    from_segments,
    from_strided_2d,
    from_strided_3d,
    plan_sequential_layout,
    walk_chain_host,
)
from .engine import (  # noqa: F401
    completion_events,
    execute_blocked,
    execute_blocked_2d,
    execute_chain_host,
    execute_serial,
)
from .simulator import (  # noqa: F401
    MEMORY_CONFIGS,
    SimConfig,
    SimResult,
    ideal_utilization,
    simulate,
    table_iv,
    utilization_sweep,
)
from .transform import (  # noqa: F401
    IDENTITY,
    TransformSpec,
    as_transform,
    kv8_roundtrip,
    kv8_roundtrip_np,
    reference_apply,
    transform_source_view,
)
from .area_model import area_kge, headline_fpga_savings, report  # noqa: F401
from .prefetch import analytical_utilization, estimate_hit_rate  # noqa: F401
from .speculation import (  # noqa: F401
    DEFAULT_DEPTH,
    DEFAULT_POLICY,
    DEPTH_WINDOW,
    AdaptiveDepth,
    DepthController,
    FixedDepth,
    SpeculationPolicy,
    as_policy,
    static_depth,
)
