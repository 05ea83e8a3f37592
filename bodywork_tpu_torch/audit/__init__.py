"""Store integrity scrubbing: the audit/fsck subsystem (the port's copy of
``bodywork_tpu.audit``; it imports neither torch nor jax).

The first subsystem that reasons about the artefact store AS A WHOLE
rather than one artefact class at a time. Three cooperating layers:

- :mod:`bodywork_tpu_torch.audit.manifest` — write-time digest sidecars (and
  compressed replicas for small non-rebuildable classes) recorded under
  ``audit/`` by the transparent :class:`AuditedStore` wrapper
  ``store.open_store`` installs;
- :mod:`bodywork_tpu_torch.audit.fsck` — the full-store scrub: every prefix
  in ``schema.ALL_PREFIXES`` audited against write-time evidence plus
  the cross-subsystem reference graph, findings graded by the
  rebuildable / restorable / data-loss / advisory taxonomy;
- :mod:`bodywork_tpu_torch.audit.repair` — the planner that executes the safe
  subset: quarantine corrupt bytes (``quarantine/``, never deleted),
  restore digest-verified redundancy, rebuild derived artefacts, demote
  dangling references.

Proof: the at-rest bit-rot chaos soak (``chaos/bitrot.py``,
``cli chaos run-sim --bit-rot``) flips bytes across every prefix of a
finished simulation and requires 100% detection + classification, with
``--repair`` converging the store byte-identical to an uncorrupted twin
outside ``quarantine/``.
"""
from bodywork_tpu_torch.audit.fsck import (
    ACTIONABLE,
    CHECKERS,
    FSCK_REPORT_SCHEMA,
    Finding,
    SEVERITIES,
    run_fsck,
)
from bodywork_tpu_torch.audit.manifest import (
    AuditedStore,
    artefact_sha256,
    read_sidecar,
    write_sidecar,
)
from bodywork_tpu_torch.audit.repair import REPAIR_ORDER, execute_repairs, quarantine

__all__ = [
    "ACTIONABLE",
    "AuditedStore",
    "CHECKERS",
    "FSCK_REPORT_SCHEMA",
    "Finding",
    "REPAIR_ORDER",
    "SEVERITIES",
    "artefact_sha256",
    "execute_repairs",
    "quarantine",
    "read_sidecar",
    "run_fsck",
    "write_sidecar",
]
