"""Ingest task: CSV/parquet long table (or the synthetic dataset) ->
catalog raw table (port of the reference's ``tasks/ingest.py``).

Conf::

    input:
      path: /data/train.csv          # .csv or .parquet; absent -> synthetic
      synthetic: {n_stores: 10, n_items: 50, n_days: 1826, seed: 0}
      validate: true                 # data-quality pre-pass (duplicates,
      validate_min_days: 60          # negatives, gaps, constant series) —
      validate_strict: false         # warn-only unless strict
      freq: D                        # cadence the feed will be tensorized at
    output:
      table: hackathon.sales.raw
"""

from __future__ import annotations

from distributed_forecasting_tpu_torch.data.dataset import (
    load_sales_csv,
    load_sales_parquet,
    synthetic_store_item_sales,
)
from distributed_forecasting_tpu_torch.data.quality import quality_report
from distributed_forecasting_tpu_torch.tasks.common import Task


class IngestTask(Task):
    def launch(self) -> str:
        inp = self.conf.get("input", {})
        out = self.conf.get("output", {})
        table = out.get("table", "hackathon.sales.raw")
        path = inp.get("path")
        if path is None:
            # hermetic mode: generate the synthetic Kaggle-shaped dataset
            synth = inp.get("synthetic", {})
            df = synthetic_store_item_sales(
                n_stores=int(synth.get("n_stores", 10)),
                n_items=int(synth.get("n_items", 50)),
                n_days=int(synth.get("n_days", 1826)),
                seed=int(synth.get("seed", 0)),
            )
            self.logger.info("generated synthetic dataset: %d rows", len(df))
        elif path.endswith(".parquet"):
            df = load_sales_parquet(path)
        else:
            df = load_sales_csv(path)
        if bool(inp.get("validate", True)):
            report = quality_report(
                df, min_days=int(inp.get("validate_min_days", 60)),
                freq=str(inp.get("freq", "D")),
            )
            for issue in report.issues:
                self.logger.warning("data quality: %s", issue)
            if report.issues and bool(inp.get("validate_strict", False)):
                raise ValueError(
                    "input.validate_strict: quality issues in the feed: "
                    + "; ".join(report.issues)
                )
            self.logger.info(
                "data quality: %d rows, %d series, %s..%s, gap ratio %.3f, "
                "%d issue(s)",
                report.n_rows, report.n_series, report.date_min,
                report.date_max, report.gap_ratio, len(report.issues),
            )
        version = self.catalog.save_table(table, df)
        self.logger.info("ingested %d rows -> %s (v%s)", len(df), table, version)
        return version


def entrypoint():
    IngestTask().launch()


if __name__ == "__main__":
    entrypoint()
