"""Registry of the model variants (counterpart of
`mpc_collisionavoidance_tpu/models/registry.py`: the same thirteen)."""

from typing import Callable, Dict

from mpc_collisionavoidance_tpu_torch.models import variants
from mpc_collisionavoidance_tpu_torch.models.base import Model

_BUILDERS: Dict[str, Callable[[], Model]] = {
    "usv_acados": variants.usv_acados,
    "usv_low_level": variants.usv_low_level,
    "usv_position_control": variants.usv_position_control,
    "usv_pf": variants.usv_pf,
    "usv_guidance_ca1": variants.usv_guidance_ca1,
    "usv_pf_ca": variants.usv_pf_ca,
    "usv_guidance": variants.usv_guidance,
    "usv_guidance2": variants.usv_guidance2,
    "usv_guidance3": variants.usv_guidance3,
    "usv_guidance4": variants.usv_guidance4,
    "usv_guidance5": variants.usv_guidance5,
    "usv_guidance_ca": variants.usv_guidance_ca,
    "race_cars": variants.race_cars,
}


def names():
    return sorted(_BUILDERS)


def get(name: str) -> Model:
    try:
        return _BUILDERS[name]()
    except KeyError:
        raise KeyError(f"unknown model '{name}'; known: {names()}") from None
