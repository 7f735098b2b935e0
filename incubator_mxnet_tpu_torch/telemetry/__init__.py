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
- `slo`: declarative objectives over registry series.

Every probe is a dead branch until the plane is armed
(``MXNET_TELEMETRY=1`` at import, or each module's ``enable()``). The
device-bound modules (compile and HBM ledgers, the profiler, the health
monitor) and `timeseries`, `burnrate` and `goodput` are not ported yet
(`ROADMAP.md`).
"""
from . import anatomy, capacity, locks, registry, slo, tracing

__all__ = ["registry", "locks", "tracing", "capacity", "anatomy", "slo"]
