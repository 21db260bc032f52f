from distributed_forecasting_tpu_torch.workflows.runner import (
    WorkflowError,
    WorkflowRunner,
    run_workflow_file,
)

__all__ = ["WorkflowError", "WorkflowRunner", "run_workflow_file"]
