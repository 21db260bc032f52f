"""Catalog bootstrap task (port of the reference's ``tasks/catalog.py``):
wraps :class:`CatalogPipeline`.  Conf shape matches
``conf/tasks/catalog_config.yml``:

    output:
      catalog_name: hackathon
      schema_name: sales
"""

from __future__ import annotations

from distributed_forecasting_tpu_torch.pipelines.catalog import CatalogPipeline
from distributed_forecasting_tpu_torch.tasks.common import Task


class CatalogTask(Task):
    def launch(self) -> None:
        self.logger.info("Launching catalog creation task")
        out = self.conf.get("output", {})
        pipeline = CatalogPipeline(
            self.catalog,
            catalog_name=out.get("catalog_name", "hackathon"),
            schema_name=out.get("schema_name", "sales"),
        )
        pipeline.initialize_catalog()
        self.logger.info("Catalog creation task finished!")


def entrypoint():  # console-script target
    CatalogTask().launch()


if __name__ == "__main__":
    entrypoint()
