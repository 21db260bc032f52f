"""Carry fitted weights between the JAX reference and the port.

Parameters cross as plain numpy arrays, one per dataclass field — the form
the reference's ``.npz`` artifacts already use — so neither package needs
the other's array type.  ``params_type`` strings recorded in artifacts map
onto the port's classes through :data:`PARAMS_TYPES`, a fixed table; the
recorded module is never imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_forecasting_tpu_torch.models.arima import ArimaParams
from distributed_forecasting_tpu_torch.models.arnet import ArnetParams
from distributed_forecasting_tpu_torch.models.croston import CrostonParams
from distributed_forecasting_tpu_torch.models.holt_winters import HWParams
from distributed_forecasting_tpu_torch.models.prophet_glm import CurveParams
from distributed_forecasting_tpu_torch.models.theta import ThetaParams
from distributed_forecasting_tpu_torch.utils.device import resolve_device

# artifact params_type -> the port's class.  The reference's names come
# first: an artifact the port writes records them too, so either package
# loads it.
PARAMS_TYPES = {
    "distributed_forecasting_tpu.models.arima:ArimaParams": ArimaParams,
    "distributed_forecasting_tpu.models.arnet:ArnetParams": ArnetParams,
    "distributed_forecasting_tpu.models.croston:CrostonParams": CrostonParams,
    "distributed_forecasting_tpu.models.holt_winters:HWParams": HWParams,
    "distributed_forecasting_tpu.models.prophet_glm:CurveParams": CurveParams,
    "distributed_forecasting_tpu.models.theta:ThetaParams": ThetaParams,
}
_TYPE_NAMES = {cls: name for name, cls in PARAMS_TYPES.items()}


def params_type_name(params) -> str:
    """The ``params_type`` string an artifact records for ``params``."""
    try:
        return _TYPE_NAMES[type(params)]
    except KeyError:
        raise TypeError(
            f"no artifact name for {type(params).__name__}; known: "
            f"{sorted(c.__name__ for c in _TYPE_NAMES)}"
        ) from None


def params_class(params_type: str) -> type:
    try:
        return PARAMS_TYPES[params_type]
    except KeyError:
        raise ValueError(
            f"artifact params_type {params_type!r} has no counterpart in "
            f"the port; known: {sorted(PARAMS_TYPES)}"
        ) from None


def params_from_numpy(cls, fields: dict, device=None):
    """Build a param dataclass ``cls`` from numpy arrays on ``device``.

    Floating arrays become float32 (the reference's only float type).
    Fields the class declares but ``fields`` lacks are back-filled from the
    class's ``_LEGACY_DEFAULTS`` (e.g. ``phi = 1`` for HW artifacts saved
    before the damped trend, the empty regressor and AR fields of a curve
    model); any other missing field raises."""
    dev = resolve_device(device)
    tensors = {}
    for k, v in fields.items():
        a = np.asarray(v)
        if np.issubdtype(a.dtype, np.floating):
            a = a.astype(np.float32)
        tensors[k] = torch.as_tensor(a, device=dev)
    declared = {f.name for f in dataclasses.fields(cls)}
    backfill = getattr(cls, "_LEGACY_DEFAULTS", {})
    for name in sorted(declared - tensors.keys()):
        if name in backfill:
            tensors[name] = backfill[name](tensors)
    return cls(**tensors)


def params_to_numpy(params) -> dict:
    """Param dataclass -> ``{field: numpy array}`` on the host."""
    return {f.name: getattr(params, f.name).detach().cpu().numpy()
            for f in dataclasses.fields(params)}


def hw_params_from_numpy(fields: dict, device=None) -> HWParams:
    """The reference's ``HWParams`` fields (numpy arrays) -> the port's."""
    return params_from_numpy(HWParams, fields, device)


def hw_params_to_numpy(params: HWParams) -> dict:
    """The port's ``HWParams`` -> numpy fields the reference's takes."""
    return params_to_numpy(params)


def curve_params_from_numpy(fields: dict, device=None) -> CurveParams:
    """The reference's ``CurveParams`` fields (numpy arrays) -> the port's."""
    return params_from_numpy(CurveParams, fields, device)


def curve_params_to_numpy(params: CurveParams) -> dict:
    """The port's ``CurveParams`` -> numpy fields the reference's takes."""
    return params_to_numpy(params)


def arima_params_from_numpy(fields: dict, device=None) -> ArimaParams:
    """The reference's ``ArimaParams`` fields (numpy arrays) -> the port's."""
    return params_from_numpy(ArimaParams, fields, device)


def arima_params_to_numpy(params: ArimaParams) -> dict:
    """The port's ``ArimaParams`` -> numpy fields the reference's takes."""
    return params_to_numpy(params)


def arnet_params_from_numpy(fields: dict, device=None) -> ArnetParams:
    """The reference's ``ArnetParams`` fields (numpy arrays) -> the port's."""
    return params_from_numpy(ArnetParams, fields, device)


def arnet_params_to_numpy(params: ArnetParams) -> dict:
    """The port's ``ArnetParams`` -> numpy fields the reference's takes."""
    return params_to_numpy(params)


def croston_params_from_numpy(fields: dict, device=None) -> CrostonParams:
    """The reference's ``CrostonParams`` fields (numpy arrays) -> the port's."""
    return params_from_numpy(CrostonParams, fields, device)


def croston_params_to_numpy(params: CrostonParams) -> dict:
    """The port's ``CrostonParams`` -> numpy fields the reference's takes."""
    return params_to_numpy(params)


def theta_params_from_numpy(fields: dict, device=None) -> ThetaParams:
    """The reference's ``ThetaParams`` fields (numpy arrays) -> the port's."""
    return params_from_numpy(ThetaParams, fields, device)


def theta_params_to_numpy(params: ThetaParams) -> dict:
    """The port's ``ThetaParams`` -> numpy fields the reference's takes."""
    return params_to_numpy(params)


def update_aux_from_numpy(aux: dict, device=None) -> dict:
    """The reference's streaming update carries (``init_update_aux``'s dict
    of numpy arrays: ``sse``, ``n_obs`` and, for croston, ``q`` / ``b``)
    -> the port's, float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in aux.items()}

