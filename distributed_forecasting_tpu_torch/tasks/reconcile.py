"""Hierarchical reconciliation task (port of the reference's
``tasks/reconcile.py``), on the task's device.

Takes the fine-grained forecast table (bottom level), builds the store x
item hierarchy, and writes coherent forecasts at every level — total, per
store, per item, per (store, item) — by bottom-up aggregation, top-down
allocation by historical proportions, or MinT-WLS with direct per-level
fits.

``method: mint`` fits every hierarchy node — aggregates and bottoms — as
one batched program from the history table; per-node rolling-origin CV
supplies the error variances (``weights: cv``), or the structural ones
(``weights: struct``), and ``reconcile.reconcile_forecasts`` gives the
trace-minimizing coherent revision.

Conf::

    input:
      table: hackathon.sales.finegrain_forecasts
      history_table: hackathon.sales.raw    # top_down proportions / mint fits
    output:
      table: hackathon.sales.reconciled_forecasts
    reconcile:
      method: bottom_up                     # or top_down | mint
      model: theta                          # mint: family for node fits
      weights: cv                           # mint: cv | struct
      horizon: 90                           # mint: forecast horizon
      cv: {initial: 730, period: 360, horizon: 90}   # mint weight windows
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pandas as pd
import torch

from distributed_forecasting_tpu_torch.reconcile.hierarchy import (
    Hierarchy,
    aggregate_bottom_up,
    reconcile_forecasts,
    top_down_allocate,
)
from distributed_forecasting_tpu_torch.tasks.common import Task


def mint_node_batch(batch, h: Hierarchy):
    """Every hierarchy node as one fit batch on the bottom series' grid, on
    the batch's device.

    Aggregate rows sum the observed bottoms and are treated as fully
    observed (a missing member contributes zero to the sum — that observed
    sum is what the aggregate is).  Bottom rows keep their own mask: a
    late-launching or gappy series must not have its missing days fit as
    observed zero sales.
    """
    n_agg = h.n_nodes - h.n_bottom
    S_agg = h.summing_matrix(batch.y.device)[:n_agg]
    y_all = torch.cat([S_agg @ (batch.y * batch.mask), batch.y])
    mask_all = torch.cat([batch.mask.new_ones(n_agg, batch.n_time),
                          batch.mask])
    return dataclasses.replace(
        batch, y=y_all, mask=mask_all,
        keys=np.stack([np.arange(h.n_nodes), np.zeros(h.n_nodes)],
                      1).astype(np.int64),
    )


def mint_error_var(mse: np.ndarray) -> np.ndarray:
    """Per-node CV MSEs as MinT weights: non-positive or non-finite entries
    take the median over the positive finite ones (1.0 if there are none).
    Constant series CV to exactly zero MSE, and a zero would let those nodes
    grab 1e12 WLS weight through ``reconcile_forecasts``' 1e-12 clamp."""
    good = np.isfinite(mse) & (mse > 0)
    fallback = float(np.median(mse[good])) if good.any() else 1.0
    return np.where(good, mse, fallback)


class ReconcileTask(Task):
    def launch(self) -> dict:
        inp = self.conf.get("input", {})
        out = self.conf.get("output", {})
        rc = self.conf.get("reconcile", {})
        method = rc.get("method", "bottom_up")
        if method == "mint":
            return self._launch_mint(inp, out, rc)

        fc = self.catalog.read_table(
            inp.get("table", "hackathon.sales.finegrain_forecasts")
        )
        fut = fc[fc["y"].isna()] if "y" in fc.columns else fc
        if fut.empty:
            fut = fc
        pivot = fut.pivot_table(
            index=["store", "item"], columns="ds", values="yhat", aggfunc="mean"
        ).sort_index()
        keys = np.asarray(list(pivot.index), dtype=np.int64)
        bottom = torch.tensor(pivot.to_numpy(dtype=np.float32),
                              device=self.device)
        h = Hierarchy.from_keys(keys)

        if method == "bottom_up":
            all_levels = aggregate_bottom_up(h, bottom)
        elif method == "top_down":
            hist = self.catalog.read_table(
                inp.get("history_table", "hackathon.sales.raw")
            )
            totals = hist.groupby(["store", "item"])["sales"].sum()
            props = torch.tensor(
                [totals.get((int(s), int(i)), 0.0) for s, i in keys],
                dtype=torch.float32, device=self.device,
            )
            all_levels = top_down_allocate(h, bottom.sum(0), props)
        else:
            raise ValueError(f"unknown reconcile method {method!r}")

        return self._write_reconciled(h, list(pivot.columns),
                                      all_levels.cpu().numpy(), method, out)

    def _write_reconciled(self, h, dates, vals, method, out,
                          extra=None) -> dict:
        """Shared output contract for every method: one long frame
        [ds, node, yhat, method], versioned catalog write, summary dict."""
        labels = h.node_labels()
        table = pd.DataFrame(
            {
                "ds": np.tile(np.asarray(dates), len(labels)),
                "node": np.repeat(labels, len(dates)),
                "yhat": vals.reshape(-1),
                "method": method,
            }
        )
        name = out.get("table", "hackathon.sales.reconciled_forecasts")
        version = self.catalog.save_table(name, table)
        self.logger.info(
            "reconciled (%s): %d nodes x %d days -> %s v%s",
            method, len(labels), len(dates), name, version,
        )
        return {
            "method": method,
            "n_nodes": len(labels),
            "n_days": len(dates),
            "table_version": version,
            **(extra or {}),
        }

    def _launch_mint(self, inp, out, rc) -> dict:
        """MinT-WLS with direct per-level fits."""
        from distributed_forecasting_tpu_torch.data.tensorize import (
            ordinals_to_dates,
            tensorize,
        )
        from distributed_forecasting_tpu_torch.engine.cv import (
            CVConfig,
            cross_validate,
        )
        from distributed_forecasting_tpu_torch.engine.fit import fit_forecast

        model = rc.get("model", "theta")
        weights = rc.get("weights", "cv")
        horizon = int(rc.get("horizon", 90))
        if weights not in ("cv", "struct"):
            raise ValueError(f"reconcile.weights must be cv|struct, "
                             f"got {weights!r}")

        hist = self.catalog.read_table(
            inp.get("history_table", "hackathon.sales.raw")
        )
        batch = tensorize(hist, device=self.device)
        h = Hierarchy.from_keys(batch.keys)
        nodes = mint_node_batch(batch, h)
        _, res = fit_forecast(nodes, model=model, horizon=horizon)
        base = res.yhat[:, batch.n_time:]  # (n_nodes, horizon)

        error_var = None
        if weights == "cv":
            cv = CVConfig(**rc.get("cv", {}))
            m = cross_validate(nodes, model=model, cv=cv)
            error_var = torch.as_tensor(
                mint_error_var(m["mse"].cpu().numpy()), device=self.device)
        coherent = reconcile_forecasts(h, base, error_var=error_var)

        dates = ordinals_to_dates(res.day_all[batch.n_time:].cpu().numpy(),
                                  batch.freq)
        summary = self._write_reconciled(
            h, dates, coherent.cpu().numpy(), f"mint_{weights}", out,
            extra={"model": model, "weights": weights},
        )
        summary["method"] = "mint"
        return summary


def entrypoint():
    ReconcileTask().launch()


if __name__ == "__main__":
    entrypoint()
