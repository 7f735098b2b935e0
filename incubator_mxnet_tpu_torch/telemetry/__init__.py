"""Runtime telemetry of the port (port of the host-side part of
`incubator_mxnet_tpu/telemetry/`):

- `registry`: counters, gauges, histograms and pull gauges;
- `locks`: named locks that witness lock order and contention;
- `tracing`: request and step spans, the Chrome-trace export and the
  crash flight recorder;
- `capacity`: the per-tenant, per-model cost ledger of the serving
  plane;
- `anatomy`: each request's wall split by state, and each serving
  replica's residency by role;
- `slo`: declarative objectives over registry series;
- `timeseries`: opt-in ring-buffer history of every registry series
  (``MXNET_TS_INTERVAL`` / ``MXNET_TS_SAMPLES``) with windowed queries,
  the signal layer of the burn-rate alerts and the autoscale advisor;
- `burnrate`: multi-window burn-rate alerts over the SLO burn gauges
  (``MXNET_BURN_WINDOWS``);
- `goodput`: the training goodput ledger (every wall second in one
  state);
- `hbm`: the device-memory census by owner (the caching allocator on the
  card), the growth watchdog (``MXNET_MEMWATCH_INTERVAL``) and the OOM
  post-mortem (``MXNET_OOM_POSTMORTEM``);
- `compiles`: the ledger of every program built (a CUDA-graph capture,
  a new prefill bucket's first run) with recompile forensics, a
  capture's FLOPs and its kernels' bytes;
- `stages`: the op funnel's per-stage µs (dead branches when off);
- `roofline`: the profiler's device trace as phases of bytes against
  time against the card's memory rate;
- `kernels`: the per-kernel census of the device trace, roofline
  placement per kernel (``bound_by``, an unknown-bytes kernel never read
  as fast), the program-ledger join, `program_mfu` and `diff_census`;
- `monitor`: `Monitor` (per-tensor health stats, one batched host
  sync), `install_nan_hook()` (eager ops, and a device flag inside a
  CUDA-graph capture), health checks and the rank statistics.

Importing the package arms the NDArray host->device inlet
(``mx_h2d_bytes_total``, `registry.add_h2d_bytes`).

Every probe is a dead branch until the plane is armed
(``MXNET_TELEMETRY=1`` at import, or each module's ``enable()``).

`fleet` is the cross-rank plane: the collective profiler on
`parallel.dist` and the mesh collectives' census, barrier arrival skew,
`fleet_report()` (per-rank and aggregate registries, a straggler score),
clock offsets and stitched multi-rank timelines, and the crash fanout's
flight dumps (`merge_flight_dumps`).
"""
from . import locks  # noqa: I001  (first: tracked_lock feeds the rest)
from . import (anatomy, burnrate, capacity, compiles, fleet, goodput, hbm,
               kernels, monitor, registry, roofline, slo, stages,
               timeseries, tracing)
from .monitor import Monitor, install_nan_hook

# arm the host->device byte inlet (a counter inc per transfer: rare
# events, so always on once telemetry is imported)
from ..ndarray import ndarray as _nd_mod  # noqa: E402

_nd_mod._H2D_HOOK = registry.add_h2d_bytes

__all__ = ["registry", "locks", "tracing", "capacity", "anatomy", "slo",
           "timeseries", "burnrate", "goodput", "hbm", "compiles",
           "stages", "roofline", "kernels", "monitor", "Monitor", "fleet",
           "install_nan_hook"]
