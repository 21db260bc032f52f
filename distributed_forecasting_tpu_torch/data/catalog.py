"""A thin named-table catalog — the Delta / Unity Catalog stand-in (own
copy of the reference's ``data/catalog.py``: the same on-disk layout, so a
table written by either package reads in the other).

Reproduces the storage + governance surface the reference leans on:
  * three-level namespace ``catalog.schema.table`` (reference
    ``notebooks/prophet/01_unity_catalog.py:9-37`` creates catalog
    ``hackathon`` and schema ``sales``; ``forecasting/pipelines/catalog.py:13-22``
    is the librarized DDL);
  * ``save_table(..., mode="overwrite")`` like Delta ``saveAsTable``
    (reference ``02_training.py:250-254,316-319``);
  * every write is **versioned** — a new snapshot directory stamped with a
    ``training_date``-style timestamp, with point-in-time reads (the reference
    stamps a ``training_date`` column and re-filters on it,
    ``02_training.py:234,308,343``);
  * grants recorded as metadata (``GRANT CREATE, USAGE ... TO account users``,
    reference ``01_unity_catalog.py:17-21``) — advisory here, but the API
    surface the tasks exercise is the same.

Layout on disk::

    root/
      <catalog>/_catalog.json               # grants + creation metadata
      <catalog>/<schema>/_schema.json
      <catalog>/<schema>/<table>/_manifest.json
      <catalog>/<schema>/<table>/v=<ts>/part-0.parquet
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import pandas as pd


class TableNotFoundError(KeyError):
    pass


class DatasetCatalog:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- namespace DDL ------------------------------------------------------
    def create_catalog(self, catalog: str, grants: Optional[List[str]] = None) -> None:
        """``CREATE CATALOG IF NOT EXISTS`` + optional grants."""
        path = os.path.join(self.root, catalog)
        os.makedirs(path, exist_ok=True)
        meta_path = os.path.join(path, "_catalog.json")
        meta = self._read_json(meta_path) or {
            "name": catalog,
            "created_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "grants": [],
        }
        for g in grants or []:
            if g not in meta["grants"]:
                meta["grants"].append(g)
        self._write_json(meta_path, meta)

    def create_schema(self, catalog: str, schema: str) -> None:
        if not os.path.isdir(os.path.join(self.root, catalog)):
            self.create_catalog(catalog)
        path = os.path.join(self.root, catalog, schema)
        os.makedirs(path, exist_ok=True)
        meta_path = os.path.join(path, "_schema.json")
        if not os.path.exists(meta_path):
            self._write_json(
                meta_path,
                {"name": schema, "created_at": time.strftime("%Y-%m-%dT%H:%M:%S")},
            )

    def catalogs(self) -> List[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isdir(os.path.join(self.root, d))
        )

    def schemas(self, catalog: str) -> List[str]:
        path = os.path.join(self.root, catalog)
        if not os.path.isdir(path):
            return []
        return sorted(
            d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d))
        )

    def tables(self, catalog: str, schema: str) -> List[str]:
        path = os.path.join(self.root, catalog, schema)
        if not os.path.isdir(path):
            return []
        return sorted(
            d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d))
        )

    def grants(self, catalog: str) -> List[str]:
        meta = self._read_json(os.path.join(self.root, catalog, "_catalog.json"))
        return list((meta or {}).get("grants", []))

    # -- table IO -----------------------------------------------------------
    def _table_dir(self, name: str) -> str:
        parts = name.split(".")
        if len(parts) != 3:
            raise ValueError(f"table name must be catalog.schema.table, got {name!r}")
        return os.path.join(self.root, *parts)

    def save_table(
        self, name: str, df: pd.DataFrame, mode: str = "overwrite"
    ) -> str:
        """Write a new versioned snapshot; returns the version id.

        ``mode="overwrite"`` makes the new snapshot current (old snapshots are
        retained for time travel); ``mode="append"`` concatenates onto the
        current snapshot into a new version.
        """
        cat, schema, _ = name.split(".")
        self.create_schema(cat, schema)
        tdir = self._table_dir(name)
        os.makedirs(tdir, exist_ok=True)
        manifest_path = os.path.join(tdir, "_manifest.json")
        manifest = self._read_json(manifest_path) or {"versions": [], "current": None}

        if mode == "append" and manifest["current"] is not None:
            df = pd.concat([self.read_table(name), df], ignore_index=True)
        elif mode not in ("overwrite", "append"):
            raise ValueError(f"unknown write mode {mode!r}")

        version = time.strftime("%Y%m%dT%H%M%S") + f".{len(manifest['versions'])}"
        vdir = os.path.join(tdir, f"v={version}")
        os.makedirs(vdir, exist_ok=True)
        df.to_parquet(os.path.join(vdir, "part-0.parquet"), index=False)
        manifest["versions"].append(
            {"id": version, "rows": int(len(df)), "written_at": version.split(".")[0]}
        )
        manifest["current"] = version
        self._write_json(manifest_path, manifest)
        return version

    def read_table(self, name: str, version: Optional[str] = None) -> pd.DataFrame:
        tdir = self._table_dir(name)
        manifest = self._read_json(os.path.join(tdir, "_manifest.json"))
        if manifest is None or manifest["current"] is None:
            raise TableNotFoundError(name)
        version = version or manifest["current"]
        vdir = os.path.join(tdir, f"v={version}")
        if not os.path.isdir(vdir):
            raise TableNotFoundError(f"{name} @ version {version}")
        return pd.read_parquet(os.path.join(vdir, "part-0.parquet"))

    def table_versions(self, name: str) -> List[str]:
        manifest = self._read_json(os.path.join(self._table_dir(name), "_manifest.json"))
        if manifest is None:
            raise TableNotFoundError(name)
        return [v["id"] for v in manifest["versions"]]

    def table_exists(self, name: str) -> bool:
        try:
            manifest = self._read_json(
                os.path.join(self._table_dir(name), "_manifest.json")
            )
        except ValueError:
            return False
        return bool(manifest and manifest["current"])

    # -- helpers ------------------------------------------------------------
    @staticmethod
    def _read_json(path: str):
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    @staticmethod
    def _write_json(path: str, obj) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=2)
        os.replace(tmp, path)
