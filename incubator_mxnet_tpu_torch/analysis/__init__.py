"""Static-analysis subsystem: the program auditor and its hazard findings
(port of `incubator_mxnet_tpu/analysis/`).

`mx.analysis.audit` inspects a program the way a CUDA-graph capture
(`hybridize()`, `DataParallel`) will see it and reports recapture,
host-sync, promotion-drift and buffer-aliasing hazards as structured
findings; `jit_cache_report` reports the graphs a block or a step keeps
capturing. `shardcheck` is the mesh pre-flight (its spec tier as the
reference's; its census tier counts one eager step's exchanges where the
reference reads the jaxpr and the compiled HLO). The concurrency pass's
report classes (`RaceReport`) are here as plain data; `racecheck_report`,
`racecheck_paths`, `racecheck_source` and `runtime_report` are
`ROADMAP.md` §1 item 11b.

Env knob: ``MXNET_ANALYSIS=warn|raise`` (see `util.env_knobs()`).
"""
from .auditor import audit, jit_cache_report  # noqa: F401
from .findings import (HAZARD_KINDS, RACE_RULES, SHARD_RULES,  # noqa: F401
                       AuditReport, Finding, RaceFinding, RaceReport,
                       ShardFinding, ShardReport)
from .shardcheck import shardcheck  # noqa: F401

__all__ = ["audit", "jit_cache_report", "AuditReport", "Finding",
           "HAZARD_KINDS", "shardcheck", "ShardReport", "ShardFinding",
           "SHARD_RULES", "RaceReport", "RaceFinding", "RACE_RULES"]
