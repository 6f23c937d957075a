"""World-state backends (counterpart of audiblelight_tpu/worldstate/): the
ray-traced mesh backend "RLR" and the image-source shoebox "SHOEBOX". The
measured-SOFA backend is not ported; resolving it by name raises."""

from typing import Type

from audiblelight_tpu_torch.worldstate.base import Emitter, WorldState
from audiblelight_tpu_torch.worldstate.mesh_backend import WorldStateRLR
from audiblelight_tpu_torch.worldstate.shoebox_backend import WorldStateShoebox

WORLDSTATE_LIST = [WorldStateRLR, WorldStateShoebox]
VALID_MOVING_EVENT_TRAJECTORIES = ["linear", "semicircular", "sine", "sawtooth", "random"]


def get_worldstate_from_string(worldstate_name: str) -> Type[WorldState]:
    """Resolve "rlr" or "shoebox" (case-insensitive) to its WorldState type."""
    name = worldstate_name.upper()
    if name == "SOFA":
        raise NotImplementedError(
            f"the {worldstate_name} backend is not ported (ROADMAP: the SOFA backend, then measured HRTFs)"
        )
    for ws in WORLDSTATE_LIST:
        if ws.name == name:
            return ws
    raise ValueError(f"Cannot find backend {worldstate_name}: expected one of RLR, SOFA, SHOEBOX")


__all__ = ["Emitter", "WorldState", "WorldStateRLR", "WorldStateShoebox", "WORLDSTATE_LIST",
           "VALID_MOVING_EVENT_TRAJECTORIES", "get_worldstate_from_string"]
