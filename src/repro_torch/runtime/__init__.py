"""Multi-channel DMA runtime: rings, channels, coalescing, completions.

The layer between workload code and the execution engines (DESIGN.md §3):
submission rings of packed descriptors (§II-D writeback as the completion
signal), N virtual channels with per-tier engines and RR/weighted
arbitration, a pre-submission coalescer, polled completion queues, and a
backpressure-aware scheduler with a fused batch-drain step.
"""
from .ring import RingEmpty, RingEntry, RingFull, SubmissionRing  # noqa: F401
from .channel import (  # noqa: F401
    Channel,
    ChannelConfig,
    ChannelStats,
    RoundRobinArbiter,
    WeightedArbiter,
)
from .coalesce import CoalesceStats, coalesce, input_hit_rate  # noqa: F401
from .completion import CompletionQueue, CompletionRecord  # noqa: F401
from .instrumentation import (  # noqa: F401
    ChannelCounters,
    PerfProbe,
    ServeCounters,
    TranslationCounters,
)
from .lowering import (  # noqa: F401
    LoweredChain,
    PlanResult,
    TranslationCache,
)
from .scheduler import (  # noqa: F401
    DMARuntime,
    SubmitResult,
    default_runtime,
)
from .submit import SubmitRequest, Ticket  # noqa: F401
