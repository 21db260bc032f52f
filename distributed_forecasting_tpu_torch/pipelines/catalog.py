"""Catalog bootstrap pipeline — the Unity-Catalog DDL equivalent (port of
the reference's ``pipelines/catalog.py``): create the catalog with its
grants and the schema, defaults ``hackathon.sales``."""

from __future__ import annotations

from distributed_forecasting_tpu_torch.data.catalog import DatasetCatalog

DEFAULT_CATALOG = "hackathon"
DEFAULT_SCHEMA = "sales"
DEFAULT_GRANTS = ["CREATE", "USAGE"]


class CatalogPipeline:
    def __init__(
        self,
        catalog: DatasetCatalog,
        catalog_name: str = DEFAULT_CATALOG,
        schema_name: str = DEFAULT_SCHEMA,
    ):
        self.catalog = catalog
        self.catalog_name = catalog_name or DEFAULT_CATALOG
        self.schema_name = schema_name or DEFAULT_SCHEMA

    def initialize_catalog(self) -> None:
        self.catalog.create_catalog(self.catalog_name, grants=DEFAULT_GRANTS)
        self.catalog.create_schema(self.catalog_name, self.schema_name)
