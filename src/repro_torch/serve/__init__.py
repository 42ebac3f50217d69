"""Online serving: versioned snapshots (:mod:`repro_torch.serve.snapshot`)
and the request-coalescing engine with a version-keyed hot-row cache and
device residency (:mod:`repro_torch.serve.engine`)."""

from repro_torch.serve.engine import (  # noqa: F401
    COUNTER_NAMES,
    HotRowCache,
    LiveClusterView,
    ServingEngine,
)
from repro_torch.serve.snapshot import (  # noqa: F401
    ServingCluster,
    ServingVersion,
    SnapshotPublisher,
    latest_version,
    list_versions,
)
