# Serving runtime of the port:
#   executor    -- the single-device executor (inmem, base and exact variants)
#   sharded     -- the mesh executor (sharded, sharded-base)
#   hostio      -- the host-I/O subsystem of the host-graph variants:
#                  multi-worker neighbour service, hot-adjacency cache,
#                  prefetched frontier exchange
#   serving     -- ServePipeline: micro-batches, a dispatch thread, result
#                  LRU, admission control, rolling stats
#   resilience  -- fault injection + fault-handling policy for the host tier
#   telemetry   -- metrics registry + exporters, request tracing (Chrome
#                  trace JSON), per-hop profiling, fault flight recorder
from .executor import SearchExecutor, SearchHandle, bucket_size, pad_batch  # noqa: F401
from .hostio import (  # noqa: F401
    HostIOConfig,
    HostIORuntime,
    HotAdjacencyCache,
    NeighborService,
)
from .resilience import FaultInjector, FaultSpec, ResilienceConfig  # noqa: F401
from .serving import BatchReport, ServePipeline, ServeStats  # noqa: F401
from .sharded import SHARDED_VARIANTS, ShardedSearchExecutor  # noqa: F401
from .telemetry import (  # noqa: F401
    FlightRecorder,
    HopProfiler,
    MetricsRegistry,
    Telemetry,
    Tracer,
)
