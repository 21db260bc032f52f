from distributed_forecasting_tpu_torch.tasks.common import Task
from distributed_forecasting_tpu_torch.tasks.catalog import CatalogTask
from distributed_forecasting_tpu_torch.tasks.ingest import IngestTask
from distributed_forecasting_tpu_torch.tasks.train import TrainTask
from distributed_forecasting_tpu_torch.tasks.deploy import DeployTask
from distributed_forecasting_tpu_torch.tasks.inference import InferenceTask
from distributed_forecasting_tpu_torch.tasks.promote import PromoteTask

# the task types the port runs; the reference's others (monitor,
# reconcile, sample_ml, serve, fleet) are not ported yet (ROADMAP Queue 1)
TASK_TYPES = {
    "catalog": CatalogTask,
    "ingest": IngestTask,
    "train": TrainTask,
    "deploy": DeployTask,
    "inference": InferenceTask,
    "promote": PromoteTask,
}

__all__ = [
    "Task",
    "CatalogTask",
    "IngestTask",
    "TrainTask",
    "DeployTask",
    "InferenceTask",
    "PromoteTask",
    "TASK_TYPES",
]
