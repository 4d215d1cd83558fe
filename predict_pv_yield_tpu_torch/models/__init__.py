"""Models of the port (torch ``nn.Module``s) and the model zoo registry.

``MODEL_REGISTRY`` maps zoo names to classes; ``MODEL_TARGETS`` maps the
``_target_`` strings of model YAMLs (the JAX package's classes and the
reference's) to the same classes, so ``configs/model/*.yaml`` resolve.
"""

from __future__ import annotations

from typing import Dict, Type

from predict_pv_yield_tpu_torch.models import baseline as _baseline
from predict_pv_yield_tpu_torch.models import conv3d_sat_nwp as _conv3d_sat_nwp

MODEL_REGISTRY: Dict[str, Type] = {
    "last_value": _baseline.Model,
    "baseline": _baseline.Model,
    "conv3d_sat_nwp": _conv3d_sat_nwp.Model,
}

MODEL_TARGETS: Dict[str, Type] = {
    "predict_pv_yield_tpu.models.baseline.Model": _baseline.Model,
    "predict_pv_yield.models.baseline.last_value.Model": _baseline.Model,
    "predict_pv_yield_tpu.models.conv3d_sat_nwp.Model": _conv3d_sat_nwp.Model,
    "predict_pv_yield.models.conv3d.model_sat_nwp.Model": _conv3d_sat_nwp.Model,
}


def get_model(name: str) -> Type:
    """The model class for a zoo name or a YAML ``_target_``."""
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if name in MODEL_TARGETS:
        return MODEL_TARGETS[name]
    raise KeyError(f"no ported model {name!r}; ported: {sorted(MODEL_REGISTRY)}")
