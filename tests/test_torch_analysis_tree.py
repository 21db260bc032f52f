"""Both packages' dflint over the port's tree, as CI lints a tree.

``distributed_forecasting_tpu_torch scripts docs`` with ``conf/`` and the
committed ``[tool.dflint]`` block and (empty) baseline, once per package
for the module (a whole-tree lint costs tens of seconds of one CPU):

* the port's own lint ends with no unsuppressed error-severity finding;
* the reference's lint of the same paths does too (its five JAX-only rules
  included);
* both report the same findings and the same number of inline
  suppressions: the port tree's markers carry the reference's rule ids.
"""

import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = ["distributed_forecasting_tpu_torch", "scripts", "docs"]


def _lint(package: str) -> dict:
    """``package``'s lint of :data:`TARGETS` under the committed config
    and baseline: the surviving findings and the suppressed count."""
    import importlib

    analysis = importlib.import_module(f"{package}.analysis")
    core = importlib.import_module(f"{package}.analysis.core")
    project = analysis.build_project(
        ROOT, [os.path.join(ROOT, t) for t in TARGETS])
    findings, suppressed = analysis.analyze(project)
    findings, baselined = core.apply_baseline(findings, core.load_baseline(
        os.path.join(ROOT, project.config.baseline)))
    return {"findings": findings, "suppressed": suppressed,
            "baselined": baselined}


@pytest.fixture(scope="module")
def port_lint():
    return _lint("distributed_forecasting_tpu_torch")


@pytest.fixture(scope="module")
def reference_lint():
    return _lint("distributed_forecasting_tpu")


def test_the_port_s_lint_of_its_tree_is_clean(port_lint):
    errors = [f.render() for f in port_lint["findings"]
              if f.severity == "error"]
    assert errors == []
    assert port_lint["baselined"] == 0  # nothing rides on a baseline
    assert port_lint["suppressed"] > 0  # the reasoned markers


def test_the_reference_s_lint_of_the_port_tree_is_clean(reference_lint):
    errors = [f.render() for f in reference_lint["findings"]
              if f.severity == "error"]
    assert errors == []
    assert reference_lint["baselined"] == 0


def test_both_lints_agree_on_the_port_tree(port_lint, reference_lint):
    key = lambda f: (f.rule, f.path, f.line, f.severity)  # noqa: E731
    assert [key(f) for f in port_lint["findings"]] == [
        key(f) for f in reference_lint["findings"]]
    assert port_lint["suppressed"] == reference_lint["suppressed"]
