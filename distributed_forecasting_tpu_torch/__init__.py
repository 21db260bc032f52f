"""distributed_forecasting_tpu_torch — the PyTorch/CUDA port of the forecasting framework.

A second package beside ``distributed_forecasting_tpu`` (the JAX reference,
which it never imports).  Module paths mirror the reference so each
counterpart is easy to find; inside, the code is plain PyTorch: functions on
tensors, frozen dataclasses of tensors for parameters, an explicit
``device`` at every entry point.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; without a card they raise
(:func:`~distributed_forecasting_tpu_torch.utils.device.resolve_device`).

Layer map of what is ported so far:
  - data plane ......... :mod:`distributed_forecasting_tpu_torch.data`
  - models ............. :mod:`distributed_forecasting_tpu_torch.models`
  - kernels ............ :mod:`distributed_forecasting_tpu_torch.ops`
                         (CUDA C++ sources under ``csrc/``)
  - fit/CV engine ...... :mod:`distributed_forecasting_tpu_torch.engine`
  - reconciliation ..... :mod:`distributed_forecasting_tpu_torch.reconcile`
  - batched serving .... :mod:`distributed_forecasting_tpu_torch.serving`
  - monitoring ......... :mod:`distributed_forecasting_tpu_torch.monitoring`
  - pipelines, tasks ... :mod:`distributed_forecasting_tpu_torch.pipelines`,
                         :mod:`distributed_forecasting_tpu_torch.tasks`,
                         :mod:`distributed_forecasting_tpu_torch.workflows`
  - weights across ..... :mod:`distributed_forecasting_tpu_torch.convert`
  - plots .............. :mod:`distributed_forecasting_tpu_torch.visualization`
                         (needs matplotlib; off the card's path)
"""

from distributed_forecasting_tpu_torch.version import __version__  # noqa: F401
