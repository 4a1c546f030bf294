"""Repo-invariant static analysis (reference:
``trivy_tpu/analysis/``), run over the port's own tree.

Two complementary halves:

* :mod:`analysis.engine` + :mod:`analysis.rules` — an AST lint
  engine whose rules encode the reference's concurrency, buffer and
  clock invariant history (the gauge-under-lock self-deadlock, the
  hostpool self-join, the monotonic-clock discipline, the
  donated-buffer rule retargeted at the port's non-blocking copies,
  the label-cardinality folds).
  ``python -m trivy_tpu_torch.analysis`` runs every rule over the
  ``trivy_tpu_torch`` tree and exits 1 on unsuppressed findings;
  ``pytest -m lint tests/test_torch_analysis.py`` runs the same
  sweep.
* :mod:`analysis.witness` — a dynamic complement: an opt-in
  instrumented-lock wrapper (``TRIVY_TPU_LOCK_WITNESS=1``) that
  records the process-wide lock-acquisition order graph and raises
  on a cycle or on a blocking pool-join from a pool thread; the
  port's seeded storms run under it.
"""

from .engine import (  # noqa: F401
    Engine,
    Finding,
    Suppression,
    analyze_source,
    analyze_tree,
    default_engine,
    parse_suppressions,
)
from .witness import (  # noqa: F401
    LockOrderViolation,
    LockWitness,
    OrderGraph,
    PoolSelfJoinError,
    install_witness,
    uninstall_witness,
)
