"""Models of the port (torch ``nn.Module``s) and the model zoo registry.

``MODEL_REGISTRY`` maps zoo names to classes; ``MODEL_TARGETS`` maps the
``_target_`` strings of model YAMLs (the JAX package's classes and the
reference's) to the same classes, so ``configs/model/*.yaml`` resolve.
"""

from __future__ import annotations

from typing import Dict, Type

from predict_pv_yield_tpu_torch.models import baseline as _baseline
from predict_pv_yield_tpu_torch.models import conv3d as _conv3d
from predict_pv_yield_tpu_torch.models import conv3d_nwp as _conv3d_nwp
from predict_pv_yield_tpu_torch.models import conv3d_sat_nwp as _conv3d_sat_nwp
from predict_pv_yield_tpu_torch.models import experimental as _experimental
from predict_pv_yield_tpu_torch.models import perceiver as _perceiver
from predict_pv_yield_tpu_torch.models import perceiver_conv3d_nwp_sat as _perceiver_conv3d_nwp_sat
from predict_pv_yield_tpu_torch.models import perceiver_nwp_sat as _perceiver_nwp_sat

MODEL_REGISTRY: Dict[str, Type] = {
    "last_value": _baseline.Model,
    "baseline": _baseline.Model,
    "conv3d": _conv3d.Model,
    "conv3d_sat_nwp": _conv3d_sat_nwp.Model,
    "conv3d_nwp": _conv3d_nwp.Model,
    "cnn_concat_timesteps": _experimental.CNNConcatTimesteps,
    "cnn_rnn": _experimental.CNNRNN,
    "perceiver": _perceiver.PerceiverModel,
    "perceiver_nwp_sat": _perceiver_nwp_sat.Model,
    "perceiver_conv3d_nwp_sat": _perceiver_conv3d_nwp_sat.Model,
}

MODEL_TARGETS: Dict[str, Type] = {
    "predict_pv_yield_tpu.models.baseline.Model": _baseline.Model,
    "predict_pv_yield.models.baseline.last_value.Model": _baseline.Model,
    "predict_pv_yield_tpu.models.conv3d.Model": _conv3d.Model,
    "predict_pv_yield.models.conv3d.model.Model": _conv3d.Model,
    "predict_pv_yield_tpu.models.conv3d_nwp.Model": _conv3d_nwp.Model,
    "predict_pv_yield.models.conv3d.model_nwp.Model": _conv3d_nwp.Model,
    "predict_pv_yield_tpu.models.experimental.CNNConcatTimesteps": _experimental.CNNConcatTimesteps,
    "predict_pv_yield_tpu.models.experimental.CNNRNN": _experimental.CNNRNN,
    "predict_pv_yield_tpu.models.conv3d_sat_nwp.Model": _conv3d_sat_nwp.Model,
    "predict_pv_yield.models.conv3d.model_sat_nwp.Model": _conv3d_sat_nwp.Model,
    "predict_pv_yield_tpu.models.perceiver.PerceiverModel": _perceiver.PerceiverModel,
    "predict_pv_yield.models.perceiver.perceiver.PerceiverModel": _perceiver.PerceiverModel,
    "predict_pv_yield_tpu.models.perceiver_nwp_sat.Model": _perceiver_nwp_sat.Model,
    "predict_pv_yield.models.perceiver.perceiver_nwp_sat.Model": _perceiver_nwp_sat.Model,
    "predict_pv_yield_tpu.models.perceiver_conv3d_nwp_sat.Model": _perceiver_conv3d_nwp_sat.Model,
    "predict_pv_yield.models.perceiver.perceiver_conv3d_nwp_sat.Model": _perceiver_conv3d_nwp_sat.Model,
}


def get_model(name: str) -> Type:
    """The model class for a zoo name or a YAML ``_target_``."""
    if name in MODEL_REGISTRY:
        return MODEL_REGISTRY[name]
    if name in MODEL_TARGETS:
        return MODEL_TARGETS[name]
    raise KeyError(f"no ported model {name!r}; ported: {sorted(MODEL_REGISTRY)}")
