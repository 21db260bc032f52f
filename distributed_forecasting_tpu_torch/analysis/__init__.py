"""dflint — repo-native static analysis of the invariants the PyTorch port
relies on (no unlocked shared serving state, no lock-order cycles or
blocking calls under a lock, no lost deadlines or trace context, no
config/schema/catalogue/protocol drift, no unseeded draws in numeric code).

The port of the reference package's ``analysis``, less the five rules whose
subject eager PyTorch does not have (``host-sync-in-hot-path``,
``tracer-leak``, ``static-argnum-drift``, ``host-reuse-after-donation``,
``recompile-churn``: no jit-traced bodies, static argnums, donated buffers
or per-signature compiles).  Rule ids, severities, messages, suppression
syntax, baseline format, SARIF output and exit codes are the reference's.

Pure AST: importing this package must never pull torch/numpy/pandas/jax.
CLI: ``python -m distributed_forecasting_tpu_torch.analysis.cli``; the
runtime join: ``python -m distributed_forecasting_tpu_torch.analysis.dftsan``.
"""

from distributed_forecasting_tpu_torch.analysis.core import (  # noqa: F401
    REGISTRY,
    DflintConfig,
    Finding,
    analyze,
    build_project,
    find_root,
)

# importing the rule modules populates REGISTRY (dftsan registers the
# runtime-fed rule shells so SARIF/--list-rules/config cover them too)
from distributed_forecasting_tpu_torch.analysis import (  # noqa: F401
    dftsan,
    protocol,
    rules_config,
    rules_drift,
    rules_lockorder,
    rules_propagation,
    rules_purity,
    rules_threads,
)

__all__ = [
    "REGISTRY",
    "DflintConfig",
    "Finding",
    "analyze",
    "build_project",
    "find_root",
    "lint_paths",
]


def lint_paths(paths, root=None, config=None, conf_dir=None):
    """Convenience wrapper for tests and embedding: lint ``paths`` and
    return the unsuppressed findings (baseline NOT applied — callers that
    want the CI behavior go through ``cli.main``)."""
    import os

    root = root or find_root(paths[0] if paths else os.getcwd())
    project = build_project(root, paths, config=config, conf_dir=conf_dir)
    findings, _ = analyze(project)
    return findings
