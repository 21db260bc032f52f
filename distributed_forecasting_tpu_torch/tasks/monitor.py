"""Monitoring task: create/run a model monitor over a forecast table (port
of the reference's ``tasks/monitor.py``; host pandas code, the same for
every device).

Conf::

    monitor:
      name: finegrain
      table: hackathon.sales.finegrain_forecasts
      granularities: ["1 day", "1 week"]
      slicing_cols: [store, item]
      anomalies: true           # also score residual z-anomalies against
      interval_width: 0.95      # the model's own band -> <table>_anomalies
      anomaly_threshold: null   # z threshold; default = the band's z
                                # (~5% of calibrated noise flags) — raise to
                                # e.g. 3.5 for alert-grade severity only
      drift: true               # PSI/KS drift vs a previous table version
      drift_baseline: null      # explicit baseline version id (default:
                                # the previous version); -> <table>_drift
      drift_columns: [y, yhat]
      degradation: true         # flag slices whose LATEST window's realized
      degradation_metric: mape  # accuracy broke from its own history
      degradation_granularity: "1 week"   # (robust z vs trailing
                                # median+MAD) -> <table>_degradation
      degradation_threshold: 3.0          # robust-z alert threshold
      degradation_min_windows: 6          # history needed for a verdict
"""

from __future__ import annotations

from distributed_forecasting_tpu_torch.monitoring import (
    MonitorConfig,
    MonitorRegistry,
    degradation_report,
    detect_anomalies,
    drift_report,
    run_monitor,
)
from distributed_forecasting_tpu_torch.tasks.common import Task


class MonitorTask(Task):
    def launch(self) -> dict:
        mc = self.conf.get("monitor", {})
        config = MonitorConfig(
            name=mc.get("name", "finegrain"),
            table=mc.get("table", "hackathon.sales.finegrain_forecasts"),
            granularities=tuple(mc.get("granularities", ("1 day", "1 week"))),
            slicing_cols=tuple(mc.get("slicing_cols", ("store", "item"))),
        )
        registry = MonitorRegistry(self._paths["warehouse"])
        registry.create_monitor(config)
        # one read shared by the profile and anomaly passes
        table_df = self.catalog.read_table(config.table)
        profile = run_monitor(self.catalog, config, df=table_df)
        self.logger.info(
            "monitor %s: %d profile rows -> %s_profile_metrics",
            config.name, len(profile), config.table,
        )
        overall = profile[
            (profile.slice_key == ":all") & (profile.granularity == "1 day")
        ]
        summary = {
            "monitor": config.name,
            "rows": len(profile),
            "daily_mape_mean": float(overall.mape.mean()),
        }
        if mc.get("anomalies", False):
            thr = mc.get("anomaly_threshold")
            scored = detect_anomalies(
                self.catalog, config.table,
                interval_width=float(mc.get("interval_width", 0.95)),
                score_threshold=float(thr) if thr is not None else None,
                df=table_df,
            )
            n_flag = int(scored.is_anomaly.sum())
            self.logger.info(
                "anomaly scan: %d/%d labeled rows flagged -> %s_anomalies",
                n_flag, len(scored), config.table,
            )
            summary["n_anomalies"] = n_flag
        if mc.get("drift", False):
            baseline = mc.get("drift_baseline")
            if baseline is None and len(
                self.catalog.table_versions(config.table)
            ) < 2:
                # first snapshot: nothing to compare yet — skip, don't
                # fail the profile/anomaly results already computed
                self.logger.info(
                    "drift scan skipped: %s has a single version (a "
                    "baseline appears at the next snapshot)", config.table,
                )
            else:
                drift = drift_report(
                    self.catalog, config.table,
                    baseline_version=baseline,
                    columns=tuple(mc.get("drift_columns", ("y", "yhat"))),
                    slicing_cols=config.slicing_cols,
                    df=table_df,
                )
                n_drift = int(drift.drifted.sum())
                self.logger.info(
                    "drift scan: %d/%d (column, slice) pairs drifted -> "
                    "%s_drift", n_drift, len(drift), config.table,
                )
                summary["n_drifted"] = n_drift
        if mc.get("degradation", False):
            gran = mc.get("degradation_granularity", "1 week")
            if gran not in config.granularities:
                raise ValueError(
                    f"degradation_granularity {gran!r} is not among the "
                    f"monitor's granularities {config.granularities}"
                )
            report = degradation_report(
                self.catalog, config, profile=profile,
                metric=mc.get("degradation_metric", "mape"),
                granularity=gran,
                z_threshold=float(mc.get("degradation_threshold", 3.0)),
                min_windows=int(mc.get("degradation_min_windows", 6)),
            )
            n_deg = int(report.degraded.sum())
            self.logger.info(
                "degradation scan: %d/%d slices broke from their history "
                "-> %s_degradation", n_deg, len(report), config.table,
            )
            summary["n_degraded"] = n_deg
        return summary


def entrypoint():
    MonitorTask().launch()


if __name__ == "__main__":
    entrypoint()
