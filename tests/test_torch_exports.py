"""The port's packages export what the reference's export.

For every package of ``distributed_forecasting_tpu`` whose ``__init__``
declares ``__all__`` (read with ``ast``: no reference module is imported),
each name is either an attribute of the port's package after it is
imported, or listed in :data:`PENDING` under the label of the ROADMAP item
that ports it.  A pending name must not be exported yet, so a slice that
ports one takes it off the list.  Packages the port does not have yet are
pending as a whole.

The same holds one level down: every module of the reference has its
counterpart in the port (unless :data:`JAX_ONLY_MODULES` pins it), and each
name of a reference module's ``__all__`` is an attribute of the port's
module, unless :data:`UNPORTED_NAMES` pins it with its reason.
"""

import ast
import importlib
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.path.join(ROOT, "distributed_forecasting_tpu")
PORT = "distributed_forecasting_tpu_torch"

# every reference package with an __all__ (test_the_package_list_is_whole)
PACKAGES = ["analysis", "data", "engine", "models", "monitoring", "ops",
            "parallel", "pipelines", "reconcile", "serving", "tasks",
            "tracking", "utils", "workflows"]

# reference packages the port does not have yet, by label
PENDING_PACKAGES = {}

# names of a reference __all__ the port does not export yet, by package and
# label (ROADMAP Queue 1): none outside the pending packages
PENDING = {}


# reference modules the port has no counterpart of, with the reason
JAX_ONLY_MODULES = {
    "analysis/absint.py": "abstract interpretation of jaxprs for the "
                          "JAX-only lint rules",
    "analysis/jaxast.py": "its framework-free half is the port's "
                          "analysis/pyast.py; the rest reads JAX idioms",
    "analysis/rules_jax.py": "lint rules about jit, tracing and XLA "
                             "recompiles: no such program in the port",
    "analysis/rules_donation.py": "lint rules about JAX buffer donation",
}

# names of a reference module's __all__ the port does not have, with the
# reason
UNPORTED_NAMES = {
    "monitoring/cost.py": {
        "extract_cost_analysis": "reads XLA's compiled cost_analysis(); "
                                 "the port publishes its kernels' *_work "
                                 "counts in its place",
    },
}


def reference_modules():
    """Every module of the reference (``__init__`` files aside), as paths
    relative to the package."""
    out = []
    for root, _, files in os.walk(REFERENCE):
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                out.append(os.path.relpath(os.path.join(root, f), REFERENCE)
                           .replace(os.sep, "/"))
    return sorted(out)


def reference_all(package: str):
    """The ``__all__`` of the reference's ``package/__init__.py``, or None
    where it declares none."""
    return module_all(os.path.join(package, "__init__.py"))


def module_all(relpath: str):
    """The ``__all__`` of the reference's module at ``relpath``, or None
    where it declares none."""
    path = os.path.join(REFERENCE, relpath)
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return None


def test_the_package_list_is_whole():
    found = sorted(
        d for d in os.listdir(REFERENCE)
        if os.path.isfile(os.path.join(REFERENCE, d, "__init__.py"))
        and reference_all(d) is not None)
    assert found == sorted(PACKAGES)
    assert set(PENDING) <= set(PACKAGES) - set(PENDING_PACKAGES)


@pytest.mark.parametrize("package", PACKAGES)
def test_port_exports_what_the_reference_exports(package):
    names = reference_all(package)
    assert names, f"the reference's {package} exports nothing"
    if package in PENDING_PACKAGES:
        assert importlib.util.find_spec(f"{PORT}.{package}") is None, (
            f"{PORT}.{package} exists now: take it off PENDING_PACKAGES "
            f"({PENDING_PACKAGES[package]}) and list what it lacks")
        return
    module = importlib.import_module(f"{PORT}.{package}")
    pending = {n: label for label, ns in PENDING.get(package, {}).items()
               for n in ns}
    assert set(pending) <= set(names), "a pending name the reference lacks"
    missing = [n for n in names if n not in pending and not hasattr(module, n)]
    assert missing == [], f"{PORT}.{package} does not export {missing}"
    ported = [f"{n} ({pending[n]})" for n in pending if hasattr(module, n)]
    assert ported == [], (
        f"{PORT}.{package} exports {ported}: take them off PENDING")
    assert set(getattr(module, "__all__", [])) >= set(names) - set(pending)


@pytest.mark.parametrize("relpath", reference_modules())
def test_port_has_every_module_and_its_exports(relpath):
    name = f"{PORT}." + relpath[:-len(".py")].replace("/", ".")
    if relpath in JAX_ONLY_MODULES:
        assert importlib.util.find_spec(name) is None, (
            f"{name} exists now: take it off JAX_ONLY_MODULES")
        return
    assert importlib.util.find_spec(name) is not None, f"no {name}"
    names = module_all(relpath)
    if names is None:
        return
    unported = UNPORTED_NAMES.get(relpath, {})
    assert set(unported) <= set(names), "a pinned name the reference lacks"
    module = importlib.import_module(name)
    missing = [n for n in names if n not in unported and not hasattr(module, n)]
    assert missing == [], f"{name} lacks {missing}"
    ported = [n for n in unported if hasattr(module, n)]
    assert ported == [], f"{name} has {ported} now: take them off the pins"
    if hasattr(module, "__all__"):
        assert set(module.__all__) >= set(names) - set(unported)


def test_the_module_pins_name_real_modules():
    modules = set(reference_modules())
    assert set(JAX_ONLY_MODULES) <= modules
    assert set(UNPORTED_NAMES) <= modules
