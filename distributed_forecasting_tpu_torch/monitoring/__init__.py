from distributed_forecasting_tpu_torch.monitoring.monitor import (
    MonitorConfig,
    MonitorRegistry,
    degradation_report,
    detect_anomalies,
    drift_report,
    run_monitor,
)

__all__ = ["MonitorConfig", "MonitorRegistry", "degradation_report",
           "detect_anomalies", "drift_report", "run_monitor"]
