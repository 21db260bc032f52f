"""Packaging for distributed_forecasting_tpu.

Parity with the reference's setuptools packaging (``setup.py:31-45`` defines
the package + ``etl``/``ml`` console scripts; extras ``[local]``/``[test]``
at ``:15-29``) — with working import paths (the reference's package dir and
import name disagree, SURVEY.md §0).
"""

from setuptools import find_packages, setup

PACKAGE = "distributed_forecasting_tpu"
# the PyTorch/CUDA port (imports torch, never jax); its CUDA sources ship as
# package data and are compiled on first use on the machine with the card
PORT = "distributed_forecasting_tpu_torch"

setup(
    name="distributed-forecasting-tpu",
    version="0.1.0",
    description=(
        "TPU-native fine-grained demand forecasting: batched per-series "
        "seasonal-trend fits compiled with XLA, sharded over device meshes"
    ),
    packages=find_packages(include=[PACKAGE, f"{PACKAGE}.*", PORT, f"{PORT}.*"]),
    package_data={PORT: ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "pandas",
        "pyyaml",
        "optax",
    ],
    extras_require={
        "local": ["pyarrow", "scikit-learn"],
        "test": ["pytest", "pytest-cov"],
        # the PyTorch/CUDA port; its kernels need nvcc and ninja at first use
        "torch": ["torch>=2.4", "ninja"],
        # real-MLflow interop lane: the adapters in tracking/mlflow_compat.py
        # run against an actual mlflow file/sqlite store
        # (tests/optional/test_mlflow_real.py; CI job mlflowInterop)
        "mlflow": ["mlflow>=2.0"],
        # Prophet parity lane: measures the headline accuracy claim
        # (BASELINE.md: <=5% CV-MAPE delta vs Prophet) against the REAL
        # prophet package (tests/optional/test_prophet_parity.py;
        # scripts/prophet_parity.py; CI job prophetParity)
        "prophet": ["prophet>=1.1"],
    },
    entry_points={
        "console_scripts": [
            # `etl`/`ml` parity (reference setup.py:37-41), namespaced
            "dftpu-catalog=distributed_forecasting_tpu.tasks.catalog:entrypoint",
            "dftpu-etl=distributed_forecasting_tpu.tasks.ingest:entrypoint",
            "dftpu-train=distributed_forecasting_tpu.tasks.train:entrypoint",
            "dftpu-deploy=distributed_forecasting_tpu.tasks.deploy:entrypoint",
            "dftpu-infer=distributed_forecasting_tpu.tasks.inference:entrypoint",
            "dftpu-serve=distributed_forecasting_tpu.tasks.serve:entrypoint",
            "dftpu-fleet=distributed_forecasting_tpu.tasks.fleet:entrypoint",
            "dftpu-ml=distributed_forecasting_tpu.tasks.sample_ml:entrypoint",
            "dftpu-monitor=distributed_forecasting_tpu.tasks.monitor:entrypoint",
            "dftpu-promote=distributed_forecasting_tpu.tasks.promote:entrypoint",
            "dftpu-reconcile=distributed_forecasting_tpu.tasks.reconcile:entrypoint",
            "dftpu-workflow=distributed_forecasting_tpu.workflows.runner:main",
        ],
    },
)
