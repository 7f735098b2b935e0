"""Structured findings of the program auditor (port of
`incubator_mxnet_tpu/analysis/findings.py`: `Finding`, `AuditReport`,
`HAZARD_KINDS`, and the sharding and concurrency report classes as plain
data).

The reference rejects bad programs in C++ static machinery before they
run; the auditor reports *hazards*, programs that run but recapture,
sync the host or promote dtypes away from the reference table, as
structured `Finding` records grouped in an `AuditReport`.

Severity contract:
- ``error``: the program cannot be captured as written (a definite host
  sync inside the abstract pass).
- ``warn``: the program runs but breaks a performance or semantics
  invariant (recapture churn, promotion drift, buffer mutation, a host
  sync seen in the eager pass).
- ``info``: advisory notes that depend on global session state; not
  counted as findings.

`ShardFinding`/`ShardReport` are the report classes `shardcheck` fills;
`RaceFinding`/`RaceReport` are racecheck's (`ROADMAP.md` §1 item 11b),
whose pass is not ported yet.
"""
from __future__ import annotations

__all__ = ["Finding", "AuditReport", "HAZARD_KINDS",
           "ShardFinding", "ShardReport", "SHARD_RULES",
           "RaceFinding", "RaceReport", "RACE_RULES"]

# The hazard classes the auditor knows about (ANALYSIS.md documents each).
HAZARD_KINDS = (
    "host-sync",                 # __bool__/__int__/.item()/asnumpy in a
                                 # would-be-captured region
    "recompile-python-scalar",   # python int/float arg baked into cache keys
    "recompile-weak-type",       # weak-typed input: cache misses on churn
    "recompile-unhashable-static",  # static kwarg that can't key a cache
    "recompile-cache-churn",     # one op holding many compiled variants
    "dtype-promotion-drift",     # result dtype != reference table
    "aliased-buffer-mutation",   # input/param rebound during the call
    "not-jittable",              # abstract pass failed (eager-only op)
    "eager-fallback",            # op deny-listed from the op-call cache
)


class Finding:
    """One hazard: (kind, message) plus where it was seen."""

    __slots__ = ("kind", "message", "severity", "op", "site")

    def __init__(self, kind, message, severity="warn", op=None, site=None):
        self.kind = kind
        self.message = message
        self.severity = severity
        self.op = op
        self.site = site

    def __repr__(self):
        where = f" [{self.op}]" if self.op else ""
        return f"<{self.severity}:{self.kind}{where} {self.message}>"

    def _key(self):
        return (self.kind, self.op, self.message)


class AuditReport:
    """Findings from one `audit()` call.

    ``findings`` (and iteration/len) cover warn+error severities — the
    contract a clean program must satisfy. ``notes`` carries info-severity
    advisories that depend on global session state (deny lists fill as the
    process runs) and therefore don't count against cleanliness.
    """

    def __init__(self, target_name):
        self.target_name = target_name
        self._all = []
        self._seen = set()
        self.jaxpr = None            # the ops the abstract pass ran, if it did

    # -- recording ----------------------------------------------------------
    def add(self, finding: Finding):
        k = finding._key()
        if k in self._seen:
            return
        self._seen.add(k)
        self._all.append(finding)

    def note(self, kind, message, severity="warn", op=None, site=None):
        self.add(Finding(kind, message, severity=severity, op=op, site=site))

    # -- reading ------------------------------------------------------------
    @property
    def findings(self):
        return [f for f in self._all if f.severity in ("warn", "error")]

    @property
    def notes(self):
        return [f for f in self._all if f.severity == "info"]

    def by_kind(self, kind):
        return [f for f in self._all if f.kind == kind]

    def __iter__(self):
        return iter(self.findings)

    def __len__(self):
        return len(self.findings)

    def summary(self):
        head = (f"audit({self.target_name}): {len(self.findings)} finding(s)"
                f", {len(self.notes)} note(s)")
        lines = [head]
        for f in self._all:
            lines.append(f"  {f!r}")
        return "\n".join(lines)

    __repr__ = summary


# ---------------------------------------------------------------------------
# Mesh-level findings (shardcheck — see analysis/shardcheck.py)
# ---------------------------------------------------------------------------

# Rule catalogue for the sharding pre-flight pass. ANALYSIS.md documents
# each with the seeded-defect fixture that demonstrates it.
SHARD_RULES = {
    "SC001": "unconstrained param: silently fully replicated on every device",
    "SC002": "shard-divisibility violation: dim % mesh-axis size != 0",
    "SC003": "spec names a mesh axis that does not exist",
    "SC004": "donation lost under sharding: donated arg's spec differs from "
             "the output it should alias (silent copy per step)",
    "SC005": "implicit cross-shard transfer: collective re-materializes a "
             "full sharded operand inside the step",
    "SC006": "per-device HBM estimate exceeds the budget",
}


class ShardFinding(Finding):
    """One sharding hazard: a Finding whose ``kind`` is an SC rule id,
    carrying the byte weight that ranks it in the report table."""

    __slots__ = ("nbytes",)

    def __init__(self, rule, message, severity="warn", site=None, nbytes=0):
        super().__init__(rule, message, severity=severity, site=site)
        self.nbytes = int(nbytes)

    @property
    def rule(self):
        return self.kind


class ShardReport(AuditReport):
    """Findings from one `shardcheck()` call, plus the mesh-level numbers
    the CLI table prints: per-device byte estimate, collective census, and
    the budget the estimate was judged against."""

    def __init__(self, target_name, mesh_axes=None):
        super().__init__(target_name)
        self.mesh_axes = dict(mesh_axes or {})   # axis name -> size
        self.per_device_bytes = 0      # static HBM estimate per device
        self.donated_bytes = 0         # bytes donated (aliased in place)
        self.budget_bytes = None       # MXNET_SHARDCHECK_HBM_GB (resolved)
        self.collectives = {}          # hlo op -> {"count": n, "bytes": b}
        self.n_leaves = 0
        self.tiers = []                # which analysis tiers actually ran

    def add_rule(self, rule, message, severity="warn", site=None, nbytes=0):
        assert rule in SHARD_RULES, rule
        self.add(ShardFinding(rule, message, severity=severity,
                              site=site, nbytes=nbytes))

    def by_rule(self, rule):
        return self.by_kind(rule)

    def stamp(self):
        """One-line machine-greppable summary — the multichip dryrun
        prints this into its metadata tail, and `tools/shardcheck.py
        --dryrun` emits the same line."""
        rules = ",".join(sorted({f.kind for f in self.findings})) or "none"
        cols = ",".join(f"{op}:{rec['count']}"
                        for op, rec in sorted(self.collectives.items())) \
            or "none"
        return (f"shardcheck[{self.target_name}] "
                f"findings={len(self.findings)} rules={rules} "
                f"per_device_mb={self.per_device_bytes / 2**20:.1f} "
                f"collectives={cols}")

    def summary(self):
        mesh = "x".join(f"{a}={s}" for a, s in self.mesh_axes.items()) or "-"
        head = (f"shardcheck({self.target_name}): {len(self.findings)} "
                f"finding(s) | mesh {mesh} | "
                f"per-device ~{self.per_device_bytes / 2**20:.1f} MiB"
                + (f" (budget {self.budget_bytes / 2**30:.2f} GiB)"
                   if self.budget_bytes else ""))
        lines = [head]
        for f in sorted(self._all, key=lambda f: -getattr(f, "nbytes", 0)):
            lines.append(f"  {f!r}")
        if self.collectives:
            lines.append("  collectives per step:")
            for op, rec in sorted(self.collectives.items()):
                lines.append(f"    {op:<20} x{rec['count']:<3} "
                             f"~{rec['bytes'] / 2**20:.2f} MiB moved")
        return "\n".join(lines)

    __repr__ = summary


# ---------------------------------------------------------------------------
# Concurrency findings (racecheck — see analysis/racecheck.py)
# ---------------------------------------------------------------------------

# Rule catalogue for the host-control-plane concurrency pass. RC001-RC004
# come from the static tier (AST dataflow over serve//fault//telemetry//
# parallel/); RC005 is witnessed at runtime by the telemetry/locks.py
# instrumented-lock registry. ANALYSIS.md documents each with its
# seeded-defect fixture.
RACE_RULES = {
    "RC001": "unguarded shared write: state reachable from >1 thread "
             "mutated outside any lock scope",
    "RC002": "read-check-act without the guarding lock: test and mutation "
             "of shared state can interleave with a peer thread",
    "RC003": "static lock-order cycle: two code paths acquire the same "
             "locks in opposite orders (potential deadlock)",
    "RC004": "blocking call (.join()/.get()/collective/long sleep) while "
             "holding a lock",
    "RC005": "runtime-witnessed lock-order inversion (cycle in the "
             "tracked-lock acquisition graph, even without a hang)",
}


class RaceFinding(Finding):
    """One concurrency hazard: a Finding whose ``kind`` is an RC rule id,
    carrying the attribute/lock pair and the witness path(s) that let a
    reader reproduce the interleaving."""

    __slots__ = ("state", "lock", "witness")

    def __init__(self, rule, message, severity="warn", site=None,
                 state=None, lock=None, witness=None):
        super().__init__(rule, message, severity=severity, site=site)
        self.state = state          # the attribute / global at stake
        self.lock = lock            # the lock (pair) involved, if any
        self.witness = tuple(witness or ())   # human-readable path lines

    @property
    def rule(self):
        return self.kind


class RaceReport(AuditReport):
    """Findings from one `racecheck_report()` call (static tier over a
    file set, plus any runtime-tier RC005 witnesses folded in)."""

    def __init__(self, target_name):
        super().__init__(target_name)
        self.n_files = 0
        self.n_entry_points = 0      # thread entry points discovered
        self.n_shared = 0            # shared attributes/globals mapped
        self.lock_graph = {}         # (lock_a, lock_b) -> witness line
        self.tiers = []              # which tiers contributed ("static",
                                     # "runtime")

    def add_rule(self, rule, message, severity="warn", site=None,
                 state=None, lock=None, witness=None):
        assert rule in RACE_RULES, rule
        self.add(RaceFinding(rule, message, severity=severity, site=site,
                             state=state, lock=lock, witness=witness))

    def by_rule(self, rule):
        return self.by_kind(rule)

    def stamp(self):
        """One-line machine-greppable summary (the dryrun meta-gate and
        `tools/racecheck.py --tree` both emit this)."""
        rules = ",".join(sorted({f.kind for f in self.findings})) or "none"
        return (f"racecheck[{self.target_name}] "
                f"findings={len(self.findings)} rules={rules} "
                f"files={self.n_files} shared={self.n_shared} "
                f"lock_edges={len(self.lock_graph)}")

    def summary(self):
        head = (f"racecheck({self.target_name}): {len(self.findings)} "
                f"finding(s) | {self.n_files} file(s), "
                f"{self.n_entry_points} thread entry point(s), "
                f"{self.n_shared} shared attr(s), "
                f"{len(self.lock_graph)} lock-order edge(s)"
                + (f" | tiers: {'+'.join(self.tiers)}" if self.tiers
                   else ""))
        lines = [head]
        for f in self._all:
            lines.append(f"  {f!r}")
            for w in getattr(f, "witness", ()):
                lines.append(f"      {w}")
        return "\n".join(lines)

    __repr__ = summary
