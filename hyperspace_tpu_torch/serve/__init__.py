"""hyperspace_tpu_torch.serve: the multi-tenant serving layer (counterpart of
`hyperspace_tpu/serve`, same exports, env knobs and metric names).

- `scheduler.QueryServer`: bounded workers, the "interactive" and "batch"
  lanes, per-tenant admission and classified `AdmissionRejectedError`
  load shedding (`Hyperspace.server()` makes one).
- `singleflight`: N identical concurrent cold requests decode the lake once.
- `replicas` (`HYPERSPACE_REPLICAS=1`): the on-lake replica registry,
  rendezvous file routing and the decode lease, epoch-file invalidation of
  the index caches and fleet-apportioned tenant budgets.
- Tenant and lane labels ride every served query's root span, ledger,
  exporter frame and Prometheus series; `telemetry.slo` judges each lane.

`HYPERSPACE_SERVING=0` turns it all off: submissions run inline and
serially, as a single caller's would.
"""

from .admission import (  # noqa: F401
    ENV_QUEUE_DEPTH,
    ENV_TENANT_BUDGET,
    AdmissionController,
    default_queue_depth,
    default_tenant_budget,
)
from .replicas import (  # noqa: F401
    ENV_REPLICA_DIR,
    ENV_REPLICAS,
    fleet_enabled,
    fleet_stats,
    join_fleet,
    leave_fleet,
    live_replicas,
    owner_of,
    replica_id,
)
from .scheduler import (  # noqa: F401
    ENV_MAX_CONCURRENT,
    LANES,
    QueryServer,
    default_max_concurrent,
)
from .singleflight import ENV_SERVING, serving_enabled, shared  # noqa: F401
