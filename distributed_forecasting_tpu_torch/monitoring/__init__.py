from distributed_forecasting_tpu_torch.monitoring.monitor import (
    Counter,
    Gauge,
    Histogram,
    IngestMetrics,
    LabeledCounter,
    LabeledGauge,
    MetricsRegistry,
    MonitorConfig,
    MonitorRegistry,
    degradation_report,
    detect_anomalies,
    drift_report,
    escape_label_value,
    render_labels,
    run_monitor,
)
from distributed_forecasting_tpu_torch.monitoring.quality import (
    QualityConfig,
    QualityMonitor,
    QualityRuntime,
    build_quality_runtime,
)
from distributed_forecasting_tpu_torch.monitoring.slo import (
    SLOConfig,
    SLOEvaluator,
    SLORule,
    latest_run_timestamp,
)
from distributed_forecasting_tpu_torch.monitoring.store import (
    QualityStoreConfig,
    ScrapeLoop,
    TimeSeriesStore,
    flatten_registry_snapshot,
)

__all__ = ["MonitorConfig", "MonitorRegistry", "degradation_report",
           "detect_anomalies", "drift_report", "run_monitor",
           "Counter", "Gauge", "Histogram", "IngestMetrics",
           "LabeledCounter", "LabeledGauge",
           "MetricsRegistry", "escape_label_value", "render_labels",
           "QualityConfig", "QualityMonitor", "QualityRuntime",
           "build_quality_runtime",
           "SLOConfig", "SLOEvaluator", "SLORule", "latest_run_timestamp",
           "QualityStoreConfig", "ScrapeLoop", "TimeSeriesStore",
           "flatten_registry_snapshot"]
