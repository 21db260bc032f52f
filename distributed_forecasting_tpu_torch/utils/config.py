"""Layered YAML config and config value helpers (own copies of the
reference's ``utils/config.py``, so the port never imports the JAX
package):

  * ``load_conf`` reads one YAML file; ``parse_conf_args`` reads
    ``--conf-file <path>`` with ``parse_known_args`` (a job runner's other
    arguments pass through), and a missing file is an empty conf;
  * ``to_jsonable`` and ``freeze`` turn config values into JSON and into
    hashable values.
"""

from __future__ import annotations

import argparse
from collections.abc import Mapping
from typing import Any, Dict, List, Optional

import numpy as np
import yaml


def load_conf(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def parse_conf_args(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--conf-file", dest="conf_file", default=None)
    ns, _unknown = p.parse_known_args(argv)
    if ns.conf_file is None:
        return {}
    try:
        return load_conf(ns.conf_file)
    except FileNotFoundError:
        return {}


class FrozenMap(Mapping):
    """Immutable, hashable mapping for dict-valued config fields, so a
    config dataclass holding one stays hashable."""

    __slots__ = ("_d",)

    def __init__(self, d):
        object.__setattr__(self, "_d", dict(d))

    def __getitem__(self, k):
        return self._d[k]

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def __hash__(self):
        return hash(tuple(sorted(self._d.items())))

    def __eq__(self, other):
        if isinstance(other, Mapping):
            return dict(self._d) == dict(other)
        return NotImplemented

    def __repr__(self):
        return f"FrozenMap({self._d!r})"


def to_jsonable(x, strict: bool = False):
    """Coerce frozen-config / numpy values to plain JSON types.
    ``strict=True`` raises on unknown types (artifact meta must round-trip);
    the default degrades to ``str(x)``."""
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, Mapping):
        return {k: to_jsonable(v, strict) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return [to_jsonable(v, strict) for v in x]
    if strict:
        raise TypeError(f"not JSON serializable: {type(x).__name__}")
    return str(x)


def freeze(value):
    """Recursively turn lists into tuples and dicts into hashable maps
    (JSON delivers sequences as lists; config dataclasses stay hashable)."""
    if isinstance(value, list):
        return tuple(freeze(v) for v in value)
    if isinstance(value, dict):
        return FrozenMap({k: freeze(v) for k, v in value.items()})
    return value
