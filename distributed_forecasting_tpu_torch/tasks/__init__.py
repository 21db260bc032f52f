from distributed_forecasting_tpu_torch.tasks.common import Task
from distributed_forecasting_tpu_torch.tasks.catalog import CatalogTask
from distributed_forecasting_tpu_torch.tasks.ingest import IngestTask
from distributed_forecasting_tpu_torch.tasks.train import TrainTask
from distributed_forecasting_tpu_torch.tasks.deploy import DeployTask
from distributed_forecasting_tpu_torch.tasks.inference import InferenceTask
from distributed_forecasting_tpu_torch.tasks.sample_ml import SampleMLTask
from distributed_forecasting_tpu_torch.tasks.monitor import MonitorTask
from distributed_forecasting_tpu_torch.tasks.promote import PromoteTask
from distributed_forecasting_tpu_torch.tasks.reconcile import ReconcileTask

# every task type of the reference's runner
TASK_TYPES = {
    "reconcile": ReconcileTask,
    "catalog": CatalogTask,
    "ingest": IngestTask,
    "train": TrainTask,
    "deploy": DeployTask,
    "inference": InferenceTask,
    "sample_ml": SampleMLTask,
    "monitor": MonitorTask,
    "promote": PromoteTask,
}

__all__ = [
    "Task",
    "CatalogTask",
    "IngestTask",
    "TrainTask",
    "DeployTask",
    "InferenceTask",
    "SampleMLTask",
    "PromoteTask",
    "MonitorTask",
    "ReconcileTask",
    "TASK_TYPES",
]
