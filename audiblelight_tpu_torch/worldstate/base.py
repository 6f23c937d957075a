"""Emitter + abstract WorldState: state shared by the world backends.

Copy of audiblelight_tpu/worldstate/base.py: aliased OrderedDicts of
microphones and emitter lists, relative-coordinate bookkeeping, alias
helpers, dict round-trip serialisation, and the abstract backend surface.
"""

from __future__ import annotations

from collections import OrderedDict
from copy import deepcopy
from typing import Any, Optional, Union

import numpy as np

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.micarrays import MicArray, _compare_dicts
from audiblelight_tpu_torch.utils import logger


class Emitter:
    """An *individual* position for a sound source within a world.

    A static Event owns a single Emitter; a moving Event owns a list of Emitters
    (one per trajectory point) under one alias.
    """

    def __init__(self, alias: str, coordinates_absolute: np.ndarray, sofa_idx: int = None):
        self.alias: str = alias
        self.coordinates_absolute: np.ndarray = utils.sanitise_coordinates(
            coordinates_absolute
        )
        # {alias: position} relative to every microphone (and optionally emitters)
        self.coordinates_relative_cartesian: OrderedDict[str, np.ndarray] = OrderedDict()
        self.coordinates_relative_polar: OrderedDict[str, np.ndarray] = OrderedDict()
        # Index of the IR/position within a SOFA file (measured-RIR backend only)
        self.sofa_idx = (
            utils.sanitise_positive_number(sofa_idx, cast_to=int)
            if sofa_idx is not None
            else None
        )
        self.has_direct_paths: OrderedDict[str, bool] = OrderedDict()

    def update_coordinates(
        self, coordinates: OrderedDict[str, Union[MicArray, list["Emitter"]]]
    ) -> None:
        """Update relative coordinates WRT {alias: MicArray | list[Emitter]}."""
        for alias, obj in coordinates.items():
            if alias == self.alias:
                self.coordinates_relative_cartesian[alias] = np.array([0.0, 0.0, 0.0])
                self.coordinates_relative_polar[alias] = np.array([0.0, 0.0, 0.0])
                continue

            if issubclass(type(obj), MicArray):
                coords = utils.sanitise_coordinates(obj.coordinates_center)
            elif isinstance(obj, list) and all(isinstance(em, Emitter) for em in obj):
                coords = np.vstack([em.coordinates_absolute for em in obj])
            else:
                raise TypeError(f"Cannot handle input with type {type(obj)}")

            pos = self.coordinates_absolute - coords
            self.coordinates_relative_cartesian[alias] = pos
            self.coordinates_relative_polar[alias] = utils.cartesian_to_polar(pos)

    def __repr__(self) -> str:
        return utils.repr_as_json(self)

    def __str__(self) -> str:
        return f"Emitter '{self.alias}' with absolute position {self.coordinates_absolute}"

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Emitter):
            return False
        return _compare_dicts(self.to_dict(), other.to_dict())

    def to_dict(self) -> dict:
        """Dictionary representation (JSON-serialisable)."""
        out = dict(
            alias=self.alias,
            coordinates_absolute=utils.coerce_nested_inputs(self.coordinates_absolute),
            has_direct_paths=dict(self.has_direct_paths),
        )
        # `is not None`, not truthiness: index 0 is a valid SOFA source
        if self.sofa_idx is not None:
            out["sofa_idx"] = self.sofa_idx
        return out

    @classmethod
    def from_dict(cls, input_dict: dict[str, Any]) -> "Emitter":
        """Instantiate an Emitter from a dictionary."""
        copied = deepcopy(input_dict)
        for k in ["alias", "coordinates_absolute"]:
            if k not in copied:
                raise KeyError(f"Missing key '{k}'")
        kws = dict(
            alias=copied["alias"],
            coordinates_absolute=np.asarray(copied["coordinates_absolute"]),
        )
        if "sofa_idx" in copied:
            kws["sofa_idx"] = copied["sofa_idx"]
        return cls(**kws)


class WorldState:
    """A 3D world: a room model, microphone position(s), and emitter position(s).

    Not used directly: instantiate WorldStateRLR (or resolve it with
    get_worldstate_from_string).
    """

    name = "_default"

    def __init__(self):
        self.emitters: OrderedDict[str, list[Emitter]] = OrderedDict()
        self.microphones: OrderedDict[str, MicArray] = OrderedDict()
        self._irs = None  # populated by `simulate`
        self.mesh = None
        self.waypoints = None
        self.ctx = None  # engine context handle, backend-specific

    # ------------------------------------------------------------------
    # Abstract surface
    # ------------------------------------------------------------------

    def _update(self) -> None:
        """Refresh derived state (relative coordinates, engine buffers)."""
        raise NotImplementedError

    def simulate(self) -> None:
        """Run acoustic propagation for the current microphones and emitters."""
        raise NotImplementedError

    def get_valid_position(self) -> np.ndarray:
        """A random valid position inside the world."""
        raise NotImplementedError

    def get_irs(self) -> OrderedDict[str, np.ndarray]:
        """IRs as {mic_alias: (n_capsules, n_emitters, n_samples)}."""
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError

    def add_microphone(self, *args, **kwargs) -> None:
        raise NotImplementedError

    def add_microphones(self, *args, **kwargs) -> None:
        raise NotImplementedError

    def add_emitter(self, *args, **kwargs) -> None:
        raise NotImplementedError

    def add_emitters(self, *args, **kwargs) -> None:
        raise NotImplementedError

    def add_microphone_and_emitter(self, *args, **kwargs) -> None:
        raise NotImplementedError

    def _validate_position(self, pos_abs: np.ndarray) -> bool:
        raise NotImplementedError

    def define_trajectory(
        self,
        duration: utils.Numeric,
        starting_position: Optional[Union[np.ndarray, list]] = None,
        velocity: Optional[utils.Numeric] = config.DEFAULT_EVENT_VELOCITY,
        resolution: Optional[utils.Numeric] = config.DEFAULT_EVENT_RESOLUTION,
        shape: Optional[str] = None,
        max_place_attempts: Optional[utils.Numeric] = config.MAX_PLACE_ATTEMPTS,
        ensure_direct_path: Optional[Union[bool, list, str]] = False,
    ) -> np.ndarray:
        raise NotImplementedError

    def path_exists_between_points(self, point_a: np.ndarray, point_b: np.ndarray) -> bool:
        raise NotImplementedError

    def _add_emitters_without_validating(
        self, emitters: Union[list, np.ndarray], alias: Optional[str]
    ) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Shared concrete behaviour
    # ------------------------------------------------------------------

    @classmethod
    def from_dict(cls, input_dict: dict[str, Any]):
        """Dispatch to the right backend's from_dict via the "backend" key."""
        if "backend" not in input_dict:
            raise KeyError("Must set 'backend' key to parse from dictionary")
        from audiblelight_tpu_torch.worldstate import get_worldstate_from_string

        desired = get_worldstate_from_string(input_dict["backend"])
        return desired.from_dict(input_dict)

    @property
    def irs(self) -> OrderedDict[str, np.ndarray]:
        """{mic_alias: (n_capsules, n_emitters, n_samples)} simulated IRs."""
        if self._irs is None:
            raise AttributeError(
                "IRs have not been simulated yet: add microphones and emitters and call `simulate`."
            )
        return self._irs

    @property
    def num_emitters(self) -> int:
        """Total Emitter count across all aliases (trajectory points included)."""
        return sum(len(v) for v in self.emitters.values())

    def __len__(self) -> int:
        return len(self.microphones) + self.num_emitters

    def __str__(self) -> str:
        return (
            f"'{self.__class__.__name__}' with {len(self)} objects "
            f"({len(self.microphones)} microphones, {self.num_emitters} emitters)"
        )

    def __repr__(self) -> str:
        return utils.repr_as_json(self)

    def __getitem__(self, alias: str) -> list[Emitter]:
        return self.get_emitters(alias)

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, type(self)):
            return False
        return _compare_dicts(self.to_dict(), other.to_dict())

    def get_emitter(self, alias: str, emitter_idx: Optional[int] = 0) -> Emitter:
        """Single Emitter: `self.emitters[alias][emitter_idx]`."""
        emitter_list = self.get_emitters(alias)
        try:
            return emitter_list[emitter_idx]
        except IndexError:
            raise IndexError(
                f"Could not get idx {emitter_idx} for a list of Emitters with length {len(emitter_list)}"
            )

    def get_emitters(self, alias: str) -> list[Emitter]:
        if alias in self.emitters:
            return self.emitters[alias]
        raise KeyError(f"Emitter alias '{alias}' not found.")

    def get_microphone(self, alias: str) -> MicArray:
        if alias in self.microphones:
            return self.microphones[alias]
        raise KeyError(f"Microphone alias '{alias}' not found.")

    def get_microphones(self) -> list[MicArray]:
        return list(self.microphones.values())

    def clear_microphones(self) -> None:
        self.microphones = OrderedDict()
        self._update()

    def clear_emitters(self) -> None:
        self.emitters = OrderedDict()
        self._update()

    def clear_microphone(self, alias: str) -> None:
        if alias in self.microphones:
            del self.microphones[alias]
            self._update()
        else:
            raise KeyError(f"Microphone alias '{alias}' not found.")

    def clear_emitter(self, alias: str) -> None:
        if alias in self.emitters:
            del self.emitters[alias]
            self._update()
        else:
            raise KeyError(f"Emitter alias '{alias}' not found.")

    def _parse_valid_microphone_aliases(
        self, aliases: Optional[Union[bool, list, str]]
    ) -> list[str]:
        """Coerce True / str / list / False|None into a validated alias list."""
        if aliases is True:
            return list(self.microphones.keys())
        if isinstance(aliases, str):
            if aliases not in self.microphones:
                raise KeyError(f"Alias {aliases} is not a valid microphone alias!")
            return [aliases]
        if isinstance(aliases, list):
            not_in = [e for e in aliases if e not in self.microphones]
            if not_in:
                raise KeyError(
                    f"Some provided microphone aliases were not found: {', '.join(not_in)}"
                )
            return list(set(aliases))
        if aliases is False or aliases is None:
            return []
        raise TypeError(f"Cannot handle input with type {type(aliases)}")

    def _register_emitter(self, emitter: Emitter, alias: str) -> None:
        """Append an Emitter to the list for `alias` (creating it if needed)."""
        if alias in self.emitters:
            self.emitters[alias].append(emitter)
        else:
            self.emitters[alias] = [emitter]

    def _update_relative_coordinates(self) -> None:
        """Refresh every emitter's relative coordinates + direct-path flags."""
        for emitter_list in self.emitters.values():
            for emitter in emitter_list:
                emitter.update_coordinates(self.microphones)
                for mic_alias, mic in self.microphones.items():
                    try:
                        emitter.has_direct_paths[mic_alias] = self.path_exists_between_points(
                            mic.coordinates_center, emitter.coordinates_absolute
                        )
                    except NotImplementedError:
                        emitter.has_direct_paths[mic_alias] = True


__all__ = ["Emitter", "WorldState", "logger"]
