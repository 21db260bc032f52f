"""nondeterminism: numeric paths must be replayable bit-for-bit.

NeuralProphet's reproducibility guidance (PAPERS.md) pins forecast drift on
hidden nondeterminism; this repo's equivalents are a bare ``np.random.*`` /
``random.*`` draw or a wall-clock read inside the numeric layers (``ops/``,
``engine/``, ``models/``) and the telemetry layer (``monitoring/``, whose
span/metric values feed dashboards that must not silently mix clock
domains).  Randomness there must flow through an explicit
``torch.Generator`` (``generator=``; the port's counterpart of the
reference's ``jax.random`` key, utils/rng.py) or a seeded
``np.random.default_rng(seed)``, and timing belongs to the
orchestration layers (``pipelines/``, ``workflows/``, ``utils/profiling``),
which this rule deliberately does not cover.

Structural exemption: the MONOTONIC clocks (``time.monotonic``,
``time.perf_counter`` and their ``_ns`` variants) are never flagged — they
measure durations, carry no wall-clock information, and are exactly what
the tracing layer (``monitoring/trace.py``) is built on.  Only wall clocks
(``time.time``/``time.time_ns``) make numeric or telemetry output depend on
*when* it ran.
"""

from __future__ import annotations

import ast
from typing import List

from distributed_forecasting_tpu_torch.analysis.core import (
    Finding,
    ModuleInfo,
    Rule,
    register,
)
from distributed_forecasting_tpu_torch.analysis.callgraph import get_callgraph

#: numpy.random constructors that ARE deterministic once given a seed
_SEEDABLE = frozenset({"default_rng", "RandomState", "SeedSequence", "Generator"})

#: torch draws that read the global generator unless given ``generator=``
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
})

#: every clock read the rule recognizes...
_ALL_CLOCKS = frozenset({
    "time.time", "time.time_ns",
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
})
#: ...minus the structurally exempt monotonic ones: duration measurement is
#: deterministic IN KIND (no wall-clock leak), so the tracing layer's span
#: timestamps never need inline suppressions
_MONOTONIC = frozenset({
    "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
})
_CLOCKS = _ALL_CLOCKS - _MONOTONIC


@register
class Nondeterminism(Rule):
    name = "nondeterminism"
    dir_names = frozenset({"ops", "engine", "models", "monitoring"})

    def check_module(self, module: ModuleInfo, project) -> List[Finding]:
        # one shared ImportMap per module for every rule pass (the
        # callgraph caches them), instead of a private re-walk here
        imap = get_callgraph(project).import_map(module)
        out: List[Finding] = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = imap.dotted(node.func)
            if dotted is None:
                continue
            if dotted.startswith("numpy.random."):
                leaf = dotted.rsplit(".", 1)[1]
                if leaf in _SEEDABLE and node.args and isinstance(
                        node.args[0], ast.Constant):
                    continue  # explicit constant seed: reproducible
                out.append(self.finding(
                    module, node,
                    f"{dotted}() in a numeric path draws from global/"
                    f"unseeded RNG state — thread a torch.Generator or a "
                    f"seeded np.random.default_rng(seed) instead"))
            elif (dotted.startswith("torch.")
                  and dotted[len("torch."):] in _TORCH_DRAWS
                  and not any(kw.arg == "generator" for kw in node.keywords)):
                out.append(self.finding(
                    module, node,
                    f"{dotted}() in a numeric path draws from torch's "
                    f"global generator — pass generator= an explicit "
                    f"seeded torch.Generator"))
            elif dotted.startswith("random.") and dotted != "random.seed":
                out.append(self.finding(
                    module, node,
                    f"{dotted}() uses Python's global RNG in a numeric "
                    f"path — results change run to run; use an explicit "
                    f"seeded generator"))
            elif dotted in _CLOCKS:
                out.append(self.finding(
                    module, node,
                    f"{dotted}() reads the wall clock inside a numeric "
                    f"path — timing belongs in pipelines/workflows; numeric "
                    f"outputs must not depend on when they ran"))
        return out
