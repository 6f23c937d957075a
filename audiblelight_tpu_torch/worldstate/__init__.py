"""World-state backends (counterpart of audiblelight_tpu/worldstate/): the
ray-traced mesh backend "RLR", the image-source shoebox "SHOEBOX" and the
measured-RIR backend "SOFA"."""

from typing import Type

from audiblelight_tpu_torch.worldstate.base import Emitter, WorldState
from audiblelight_tpu_torch.worldstate.mesh_backend import WorldStateRLR
from audiblelight_tpu_torch.worldstate.shoebox_backend import WorldStateShoebox
from audiblelight_tpu_torch.worldstate.sofa_backend import WorldStateSOFA

WORLDSTATE_LIST = [WorldStateRLR, WorldStateSOFA, WorldStateShoebox]
VALID_MOVING_EVENT_TRAJECTORIES = ["linear", "semicircular", "sine", "sawtooth", "random"]


def get_worldstate_from_string(worldstate_name: str) -> Type[WorldState]:
    """Resolve "rlr", "sofa" or "shoebox" (case-insensitive) to its WorldState type."""
    name = worldstate_name.upper()
    for ws in WORLDSTATE_LIST:
        if ws.name == name:
            return ws
    raise ValueError(f"Cannot find backend {worldstate_name}: expected one of RLR, SOFA, SHOEBOX")


__all__ = ["Emitter", "WorldState", "WorldStateRLR", "WorldStateSOFA", "WorldStateShoebox", "WORLDSTATE_LIST",
           "VALID_MOVING_EVENT_TRAJECTORIES", "get_worldstate_from_string"]
