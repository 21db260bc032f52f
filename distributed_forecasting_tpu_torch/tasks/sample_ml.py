"""Sample ML task — template-parity demo task (port of the reference's
``tasks/sample_ml.py``; host scikit-learn code).

The reference ships a template sklearn task (``forecasting/tasks/
sample_ml_task.py:1-55``): read a table, build a
StandardScaler+RandomForestRegressor pipeline, train/test split, log r2 to
MLflow under an experiment from conf.  Same demo against the framework's
catalog + tracker, so the Task surface is exercised end-to-end without the
forecasting stack.

Conf::

    input:
      table: hackathon.sales.raw
    experiment: sample_ml
"""

from __future__ import annotations

from distributed_forecasting_tpu_torch.tasks.common import Task


class SampleMLTask(Task):
    def get_pipeline(self):
        from sklearn.ensemble import RandomForestRegressor
        from sklearn.pipeline import Pipeline
        from sklearn.preprocessing import StandardScaler

        return Pipeline(
            [
                ("scaler", StandardScaler()),
                ("model", RandomForestRegressor(n_estimators=25, random_state=0)),
            ]
        )

    def launch(self) -> float:
        from sklearn.metrics import r2_score
        from sklearn.model_selection import train_test_split

        table = self.conf.get("input", {}).get("table", "hackathon.sales.raw")
        df = self.catalog.read_table(table)
        # demo target: predict sales from calendar + key features
        df = df.copy()
        df["dow"] = df["date"].dt.dayofweek
        df["doy"] = df["date"].dt.dayofyear
        X = df[["store", "item", "dow", "doy"]].to_numpy()
        y = df["sales"].to_numpy()
        X_tr, X_te, y_tr, y_te = train_test_split(X, y, random_state=42)

        pipeline = self.get_pipeline()
        pipeline.fit(X_tr, y_tr)
        r2 = float(r2_score(y_te, pipeline.predict(X_te)))

        eid = self.tracker.create_experiment(self.conf.get("experiment", "sample_ml"))
        with self.tracker.start_run(eid, run_name="sample_ml") as run:
            run.log_params({"n_estimators": 25, "rows": len(df)})
            run.log_metrics({"r2": r2})
        self.logger.info("sample_ml r2=%.4f", r2)
        return r2


def entrypoint():
    SampleMLTask().launch()


if __name__ == "__main__":
    entrypoint()
