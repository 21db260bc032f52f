"""The port stands alone: no JAX, no reference package, no quiet CPU runs.

- No module of ``distributed_forecasting_tpu_torch`` and not
  ``chip_smoke.py`` imports ``jax``/``jaxlib`` or
  ``distributed_forecasting_tpu`` (an AST scan of every import).
- Importing the whole port in a fresh interpreter leaves ``jax`` out of
  ``sys.modules``, and ``matplotlib`` too (only ``visualization``'s plot
  functions import it, when called).
- Every entry point that places tensors raises when no CUDA device is
  visible, unless the caller passes ``device="cpu"``.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "distributed_forecasting_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "distributed_forecasting_tpu")

torch.set_num_threads(1)


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_port_file_imports_jax_or_the_reference():
    files = _port_sources()
    assert len(files) > 15 and os.path.exists(files[0])
    bad = [(os.path.relpath(p, ROOT), mod) for p in files
           for mod in _imported_modules(p)
           if mod.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_importing_the_port_leaves_jax_unloaded():
    code = (
        "import sys\n"
        "import distributed_forecasting_tpu_torch.convert\n"
        "import distributed_forecasting_tpu_torch.data\n"
        "import distributed_forecasting_tpu_torch.engine\n"
        "import distributed_forecasting_tpu_torch.ops._build\n"
        "import distributed_forecasting_tpu_torch.pipelines.training\n"
        "import distributed_forecasting_tpu_torch.monitoring.quality\n"
        "import distributed_forecasting_tpu_torch.monitoring.slo\n"
        "import distributed_forecasting_tpu_torch.monitoring.store\n"
        "import distributed_forecasting_tpu_torch.serving.anomaly\n"
        "import distributed_forecasting_tpu_torch.serving\n"
        "import distributed_forecasting_tpu_torch.serving.server\n"
        "import distributed_forecasting_tpu_torch.tasks\n"
        "import distributed_forecasting_tpu_torch.tasks.serve\n"
        "import distributed_forecasting_tpu_torch.tracking\n"
        "import distributed_forecasting_tpu_torch.workflows.runner\n"
        "import distributed_forecasting_tpu_torch.data.eda\n"
        "import distributed_forecasting_tpu_torch.engine.autoprep\n"
        "import distributed_forecasting_tpu_torch.engine.compile_cache\n"
        "import distributed_forecasting_tpu_torch.engine.executor\n"
        "import distributed_forecasting_tpu_torch.engine.gradfit\n"
        "import distributed_forecasting_tpu_torch.engine.hyper\n"
        "import distributed_forecasting_tpu_torch.engine.windowed\n"
        "import distributed_forecasting_tpu_torch.models.arnet\n"
        "import distributed_forecasting_tpu_torch.ops.optim\n"
        "import distributed_forecasting_tpu_torch.ops.precision\n"
        "import distributed_forecasting_tpu_torch.ops.kalman\n"
        "import distributed_forecasting_tpu_torch.models.arima\n"
        "import distributed_forecasting_tpu_torch.engine.select\n"
        "import distributed_forecasting_tpu_torch.engine.order\n"
        "import distributed_forecasting_tpu_torch.utils.rng\n"
        "import distributed_forecasting_tpu_torch.monitoring.cost\n"
        "import distributed_forecasting_tpu_torch.monitoring.trace\n"
        "import distributed_forecasting_tpu_torch.utils.platform\n"
        "import distributed_forecasting_tpu_torch.ops.clean\n"
        "import distributed_forecasting_tpu_torch.parallel\n"
        "import distributed_forecasting_tpu_torch.serving.forecast_cache\n"
        "import distributed_forecasting_tpu_torch.serving.ingest\n"
        "import distributed_forecasting_tpu_torch.serving.refit\n"
        "import distributed_forecasting_tpu_torch.engine.state_store\n"
        "import distributed_forecasting_tpu_torch.ops.update\n"
        "import distributed_forecasting_tpu_torch.tracking.mlflow_compat\n"
        "import distributed_forecasting_tpu_torch.version\n"
        "import distributed_forecasting_tpu_torch.visualization\n"
        "assert 'matplotlib' not in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_run_without_a_card(no_cuda, tmp_path):
    from distributed_forecasting_tpu_torch import convert, data
    from distributed_forecasting_tpu_torch.data import native
    from distributed_forecasting_tpu_torch.engine import fit_forecast
    from distributed_forecasting_tpu_torch.models import HoltWintersConfig
    from distributed_forecasting_tpu_torch.parallel import (
        initialize_distributed,
        make_mesh,
    )
    from distributed_forecasting_tpu_torch.serving import BatchForecaster

    df = data.synthetic_store_item_sales(n_stores=1, n_items=2, n_days=40)
    csv = str(tmp_path / "sales.csv")
    df.to_csv(csv, index=False, date_format="%Y-%m-%d")
    calls = {
        "tensorize": lambda d: data.tensorize(df, device=d),
        "synthetic_series_batch": lambda d: data.synthetic_series_batch(
            n_stores=1, n_items=2, n_days=40, device=d),
        "hw_params_from_numpy": lambda d: convert.hw_params_from_numpy(
            {"alpha": np.ones(2, np.float32)}, device=d),
        "curve_params_from_numpy": lambda d: convert.curve_params_from_numpy(
            {"beta": np.ones((2, 3), np.float32)}, device=d),
        "arnet_params_from_numpy": lambda d: convert.arnet_params_from_numpy(
            {"w": np.ones((2, 3), np.float32)}, device=d),
        "update_aux_from_numpy": lambda d: convert.update_aux_from_numpy(
            {"sse": np.ones(2, np.float32)}, device=d),
        "regressors_for_grid": lambda d: data.regressors_for_grid(
            df.assign(p=1.0), day0=15706, n_days=10, regressor_cols=["p"],
            per_series=True, keys=np.array([[1, 1]]),
            key_names=("store", "item"), device=d),
        "load_and_tensorize_csv": lambda d: native.load_and_tensorize_csv(
            csv, device=d),
        # the series mesh and a rank's bring-up: refused before any group
        "make_mesh": lambda d: make_mesh(device=d),
        "initialize_distributed": lambda d: initialize_distributed(
            "127.0.0.1:1", 2, 0, device=d),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(None)
        with pytest.raises(RuntimeError, match="no CUDA"):
            call("cuda")
    # the same calls on request run on the CPU
    batch = calls["tensorize"]("cpu")
    assert batch.y.device.type == "cpu"
    params, _ = fit_forecast(batch, "holt_winters", horizon=5)
    fc = BatchForecaster.from_fit(batch, params, "holt_winters",
                                  HoltWintersConfig())
    fc.save(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchForecaster.load(str(tmp_path))
    assert BatchForecaster.load(str(tmp_path), device="cpu").device.type == "cpu"
    # streaming ingest: the state store and the runtime that builds it
    from distributed_forecasting_tpu_torch.engine.state_store import (
        SeriesStateStore,
    )
    from distributed_forecasting_tpu_torch.serving.ingest import (
        build_ingest_runtime,
    )

    conf = {"enabled": True, "wal_dir": str(tmp_path / "wal")}
    for make in (lambda d: SeriesStateStore(fc, device=d),
                 lambda d: build_ingest_runtime(conf, fc, device=d)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(None)
        with pytest.raises(RuntimeError, match="no CUDA"):
            make("cuda")
    assert SeriesStateStore(fc, device="cpu").device.type == "cpu"


def test_task_layer_refuses_to_run_without_a_card(no_cuda, tmp_path,
                                                  monkeypatch):
    """Task (the serve task's too), TrainingPipeline and WorkflowRunner
    resolve their device when built: without a card they raise unless asked
    for the CPU, by argument or by the DFTPU_PLATFORM switch."""
    from distributed_forecasting_tpu_torch.data import DatasetCatalog
    from distributed_forecasting_tpu_torch.pipelines.training import (
        TrainingPipeline,
    )
    from distributed_forecasting_tpu_torch.tasks import CatalogTask
    from distributed_forecasting_tpu_torch.tasks.serve import ServeTask
    from distributed_forecasting_tpu_torch.tracking import FileTracker
    from distributed_forecasting_tpu_torch.workflows import WorkflowRunner

    monkeypatch.delenv("DFTPU_PLATFORM", raising=False)
    conf = {"env": {"root": str(tmp_path)}}
    catalog = DatasetCatalog(str(tmp_path / "w"))
    tracker = FileTracker(str(tmp_path / "t"))
    calls = {
        "Task": lambda d: CatalogTask(init_conf=conf, device=d),
        "ServeTask": lambda d: ServeTask(init_conf=conf, device=d),
        "TrainingPipeline": lambda d: TrainingPipeline(catalog, tracker,
                                                       device=d),
        "WorkflowRunner": lambda d: WorkflowRunner({"workflows": []},
                                                   device=d),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call(None)
        with pytest.raises(RuntimeError, match="no CUDA"):
            call("cuda")
        assert call("cpu").device.type == "cpu"
    monkeypatch.setenv("DFTPU_PLATFORM", "cpu")
    assert calls["Task"](None).device.type == "cpu"
    assert calls["ServeTask"](None).device.type == "cpu"
    assert calls["WorkflowRunner"](None).device.type == "cpu"
    # the switch is the task layer's: library entry points ignore it
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls["TrainingPipeline"](None)
    monkeypatch.setenv("DFTPU_PLATFORM", "gpu")
    with pytest.raises(RuntimeError, match="no CUDA"):
        calls["Task"](None)
