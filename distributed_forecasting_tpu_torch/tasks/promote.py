"""Promote task: metric-gated stage transition, champion/challenger (port of
the reference's ``tasks/promote.py``).  The candidate version's training
metric (from the run each registry version points at) is compared with the
current champion's, and the stage transition happens only if the candidate
is at least as good, so a scheduled retrain cannot silently replace a
healthy Production model with a worse one.

Conf::

    promote:
      model_name: ForecastingBatchModel
      candidate_stage: Staging        # where challengers wait (or
      candidate_version: null         #   pin an explicit version)
      target_stage: Production        # where the champion lives
      metric: val_smape               # compared from each version's run
      rule: not_worse                 # not_worse | improved
      tolerance: 0.02                 # not_worse: candidate may be up to
                                      #   2% worse and still pass
      fail_on_reject: false           # true -> a rejected candidate fails
                                      #   the workflow (CI-gate style)
      require_comparable: false       # true -> refuse (not just warn) when
                                      #   the two runs' cv_protocol or
                                      #   data_span params differ

No champion in ``target_stage`` yet: the candidate promotes
unconditionally (first deployment).  Higher-is-better metrics (coverage)
orient automatically.  The decision, both metric values and the baseline
version are stamped onto the candidate as version tags either way.
"""

from __future__ import annotations

import numpy as np

from distributed_forecasting_tpu_torch.engine.select import _HIGHER_BETTER
from distributed_forecasting_tpu_torch.tasks.common import Task


def _is_higher_better(metric: str) -> bool:
    """The engine's orientation set; metrics arrive here with the run
    logger's ``val_`` prefix."""
    name = metric[4:] if metric.startswith("val_") else metric
    return name in _HIGHER_BETTER


# run params (pipelines/training._comparability_params) that must match
# between candidate and champion for their val_* metrics to be strictly
# comparable; a mismatch means the DATA changed, not (only) the model
_COMPARABILITY_KEYS = ("cv_protocol", "data_span")


class PromoteTask(Task):
    def _run(self, version):
        exp_name = (version.tags or {}).get("source_experiment")
        if not exp_name:
            raise KeyError(
                f"version v{version.version} has no source_experiment tag — "
                f"register it through DeployTask so promotion can find its "
                f"training run"
            )
        eid = self.tracker.get_experiment_by_name(exp_name)
        if eid is None:
            raise KeyError(f"experiment {exp_name!r} not found")
        return self.tracker.get_run(eid, version.run_id)

    def _run_metric(self, run, version, metric: str) -> float:
        metrics = run.metrics()
        if metric not in metrics:
            raise KeyError(
                f"run {version.run_id} has no metric {metric!r} "
                f"(has: {sorted(metrics)})"
            )
        value = float(metrics[metric])
        if not np.isfinite(value):
            # NaN comparisons decide silently (a NaN champion would reject
            # every future candidate forever; a NaN candidate would promote
            # unconditionally on first deployment) — refuse to gate on one
            raise ValueError(
                f"run {version.run_id} logged non-finite {metric}={value} — "
                f"cannot gate a promotion on it (pin candidate_version to "
                f"override, or fix the training run)"
            )
        return value

    def launch(self) -> dict:
        pr = self.conf.get("promote", {})
        model_name = pr.get("model_name", "ForecastingBatchModel")
        cand_stage = pr.get("candidate_stage", "Staging")
        target = pr.get("target_stage", "Production")
        metric = pr.get("metric", "val_smape")
        rule = pr.get("rule", "not_worse")
        tolerance = float(pr.get("tolerance", 0.02))
        if rule not in ("not_worse", "improved"):
            raise ValueError(f"unknown promote.rule {rule!r}; "
                             f"'not_worse' or 'improved'")

        cand_v = pr.get("candidate_version")
        if cand_v is not None:
            candidate = self.registry.get_version(model_name, int(cand_v))
        else:
            candidate = self.registry.latest_version(model_name,
                                                     stage=cand_stage)
        cand_run = self._run(candidate)
        cand_metric = self._run_metric(cand_run, candidate, metric)

        try:
            baseline = self.registry.latest_version(model_name, stage=target)
        except KeyError:
            baseline = None

        higher_better = _is_higher_better(metric)
        if baseline is None:
            decision, base_metric = True, None
            reason = f"no champion in {target} yet"
        elif baseline.version == candidate.version:
            raise ValueError(
                f"candidate v{candidate.version} already holds {target}"
            )
        else:
            base_run = self._run(baseline)
            base_metric = self._run_metric(base_run, baseline, metric)
            # a champion trained months earlier saw a different history
            # window (and maybe CV config) — its val_* is then not strictly
            # comparable to the candidate's, and the gate could decide on
            # the data change rather than the model
            cp, bp = cand_run.params(), base_run.params()
            legacy = [
                name for name, params in
                (("champion", bp), ("candidate", cp))
                if not any(k in params for k in _COMPARABILITY_KEYS)
            ]
            if legacy:
                # a run from before comparability stamping (either side —
                # e.g. a pinned older candidate): unknown, not mismatched —
                # warn but never refuse, or the flag would block every
                # promotion involving such a run until a retrain
                self.logger.warning(
                    "%s run(s) predate comparability stamping (no "
                    "cv_protocol/data_span params) — cannot check whether "
                    "the runs scored the same window",
                    " and ".join(legacy),
                )
                mismatch = []
            else:
                mismatch = [
                    f"{k}: candidate={cp.get(k)!r} champion={bp.get(k)!r}"
                    for k in _COMPARABILITY_KEYS if cp.get(k) != bp.get(k)
                ]
            if mismatch:
                msg = (
                    f"candidate and champion runs are not strictly "
                    f"comparable ({'; '.join(mismatch)}) — the gate may "
                    f"reflect the data change, not the model"
                )
                if bool(pr.get("require_comparable", False)):
                    raise RuntimeError(
                        msg + " (require_comparable is set; retrain the "
                        "champion on the current window, or unset "
                        "require_comparable to gate with a warning)"
                    )
                self.logger.warning(msg)
            c, b = cand_metric, base_metric
            if higher_better:
                c, b = -c, -b  # orient so smaller is better
            # tolerance widens the bound by a FRACTION OF THE MAGNITUDE in
            # oriented space: b*(1+tol) would flip direction for negative b
            # (any higher-better metric, bias-style metrics) and demand the
            # candidate be BETTER instead of allowing slightly worse
            bound = b + tolerance * abs(b) if rule == "not_worse" else b
            decision = c <= bound if rule == "not_worse" else c < bound
            cmp = "<=" if rule == "not_worse" else "<"
            reason = (
                f"{metric}: candidate {cand_metric:.6g} {cmp} champion "
                f"{base_metric:.6g}"
                + (f" (+{tolerance:.0%} tolerance)"
                   if rule == "not_worse" else "")
                + f" -> {'pass' if decision else 'fail'}"
            )

        # stamp the decision on the candidate either way: the registry
        # should record WHY a version did or did not ship
        for k, v in {
            "promotion_decision": "promoted" if decision else "rejected",
            "promotion_metric": metric,
            "promotion_candidate_value": f"{cand_metric:.6g}",
            "promotion_baseline_value":
                "" if base_metric is None else f"{base_metric:.6g}",
            "promotion_baseline_version":
                "" if baseline is None else str(baseline.version),
            "promotion_reason": reason,
        }.items():
            self.registry.set_version_tag(model_name, candidate.version, k, v)

        if decision:
            self.registry.transition_stage(model_name, candidate.version,
                                           target)
            self.logger.info(
                "promoted %s v%d -> %s (%s)", model_name, candidate.version,
                target, reason,
            )
        else:
            self.logger.warning(
                "REJECTED %s v%d for %s (%s)", model_name, candidate.version,
                target, reason,
            )
            if bool(pr.get("fail_on_reject", False)):
                raise RuntimeError(
                    f"promotion gate failed for {model_name} "
                    f"v{candidate.version}: {reason}"
                )
        return {
            "model_name": model_name,
            "candidate_version": candidate.version,
            "promoted": bool(decision),
            "metric": metric,
            "candidate_value": cand_metric,
            "baseline_value": base_metric,
            "reason": reason,
        }


def entrypoint():
    PromoteTask().launch()


if __name__ == "__main__":
    entrypoint()
