"""Microphone rigs: capsule geometry and channel layouts.

Counterpart of audiblelight_tpu/micarrays.py: the capsule rigs ("mic", one
omni channel per capsule: the AmbeoVR tetrahedron, the Eigenmike em32 and
em64 spheres, a single mono capsule, and rigs defined at run time by
`dynamically_define_micarray`) and the one-point listeners: first-order
ambisonics ("foa", AmbiX channels W, X, Y, Z), higher-order ambisonics
("hoa3" by default, or "hoa2"; ACN/SN3D) and the binaural head ("binaural",
left and right: the analytic spherical head, or a measured HRTF set read
from a SOFA file).
"""

from __future__ import annotations

from collections import OrderedDict
from copy import deepcopy
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Type

import numpy as np

from audiblelight_tpu_torch import utils
from audiblelight_tpu_torch.utils import logger

CHANNEL_LAYOUT_TYPES = ["mic", "foa", "binaural", "hoa2", "hoa3"]


class ChannelLayoutType(Enum):
    """Receiver directivity model of the RIR backends."""

    Mono = "mono"
    Ambisonics = "ambisonics"
    Binaural = "binaural"


@dataclass(frozen=True)
class ChannelLayout:
    """A receiver channel layout: directivity type + number of output channels."""

    layout_type: ChannelLayoutType
    channel_count: int


def _compare_dicts(d1: dict, d2: dict, exclude: tuple = (), sig_digits: int = 4) -> bool:
    """Order-insensitive approximate dict equality."""

    def norm(v):
        if isinstance(v, (list, tuple)):
            return tuple(norm(x) for x in v)
        if isinstance(v, np.ndarray):
            return tuple(norm(x) for x in v.tolist())
        if isinstance(v, (float, np.floating, int, np.integer)) and not isinstance(v, bool):
            return round(float(v), sig_digits)
        if isinstance(v, dict):
            return tuple(sorted((k, norm(val)) for k, val in v.items()))
        return v

    keys = (set(d1) | set(d2)) - set(exclude)
    return all(norm(d1.get(k)) == norm(d2.get(k)) for k in keys)


@dataclass(eq=False)
class MicArray:
    """Base class of the microphone rigs: name, layout type, and the
    absolute capsule positions once `set_absolute_coordinates` placed it."""

    name: str = ""
    is_spherical: bool = False
    channel_layout_type: str = "mic"

    irs: np.ndarray = field(default=None, init=False, repr=False)
    _coordinates_absolute: np.ndarray = field(default=None, init=False, repr=False)
    _coordinates_center: np.ndarray = field(default=None, init=False, repr=False)

    @property
    def channel_layout(self) -> ChannelLayout:
        counts = {"mic": (ChannelLayoutType.Mono, 1), "foa": (ChannelLayoutType.Ambisonics, 4),
                  "hoa2": (ChannelLayoutType.Ambisonics, 9), "hoa3": (ChannelLayoutType.Ambisonics, 16),
                  "binaural": (ChannelLayoutType.Binaural, 2)}
        if self.channel_layout_type not in counts:
            raise ValueError(
                f"Expected 'channel_layout_type' to be one of {', '.join(CHANNEL_LAYOUT_TYPES)} "
                f"but got '{self.channel_layout_type}'"
            )
        return ChannelLayout(*counts[self.channel_layout_type])

    @property
    def n_listeners(self) -> int:
        """Receiver points: one per capsule for "mic", one for the others."""
        if self.channel_layout_type == "mic":
            return self.n_capsules
        if self.channel_layout_type in ("foa", "binaural", "hoa2", "hoa3"):
            return 1
        raise ValueError(
            f"Expected 'channel_layout_type' to be one of {', '.join(CHANNEL_LAYOUT_TYPES)}, "
            f"but got '{self.channel_layout_type}'"
        )

    @property
    def n_channels(self) -> int:
        """Output audio channels."""
        return self.n_listeners * self.channel_layout.channel_count

    @property
    def coordinates_polar(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def coordinates_cartesian(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def coordinates_absolute(self) -> np.ndarray:
        if self._coordinates_absolute is None:
            raise NotImplementedError("Must call `.set_absolute_coordinates` first!")
        return np.asarray(self._coordinates_absolute)

    @property
    def coordinates_center(self) -> np.ndarray:
        if self._coordinates_center is None:
            raise NotImplementedError("Must call `.set_absolute_coordinates` first!")
        return np.asarray(self._coordinates_center)

    @property
    def n_capsules(self) -> int:
        return len(self.capsule_names)

    @property
    def capsule_names(self) -> list[str]:
        return []

    def set_absolute_coordinates(self, mic_center: np.ndarray) -> np.ndarray:
        """Place the rig's centre at `mic_center` (metres)."""
        self._coordinates_center = np.asarray(mic_center, dtype=float)
        self._coordinates_absolute = self.coordinates_cartesian + utils.coerce2d(self._coordinates_center)
        return self._coordinates_absolute

    def __len__(self) -> int:
        return self.n_capsules

    def __repr__(self) -> str:
        return utils.repr_as_json(self)

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, MicArray):
            return False
        return _compare_dicts(self.to_dict(), other.to_dict(), exclude=("micarray_type",))

    def to_dict(self) -> dict:
        coord_dict = OrderedDict()
        for coord_type in ("coordinates_absolute", "coordinates_center", "coordinates_polar",
                           "coordinates_cartesian"):
            try:
                coord_val = getattr(self, coord_type)
            except NotImplementedError:
                coord_val = None
            else:
                if isinstance(coord_val, np.ndarray):
                    coord_val = coord_val.tolist()
            coord_dict[coord_type] = coord_val
        return dict(
            name=self.name,
            micarray_type=self.__class__.__name__,
            is_spherical=self.is_spherical,
            channel_layout_type=self.channel_layout_type,
            n_capsules=self.n_capsules,
            capsule_names=self.capsule_names,
            **coord_dict,
        )

    def _set_attribute(self, attr_name: str, value: Any) -> None:
        """Deserialisation setter: read-only properties are checked against
        the stored value instead of overwritten; a mismatch raises."""
        if value is None:
            return
        if isinstance(value, list) and value and not isinstance(value[0], str):
            value = np.asarray(value)
        try:
            hasat = hasattr(self, attr_name)
        except NotImplementedError:
            return
        if not hasat:
            return
        try:
            setattr(self, attr_name, value)
        except AttributeError:
            expected = getattr(self, attr_name)
            if isinstance(value, np.ndarray):
                eq = np.isclose(np.asarray(expected, dtype=float), value, atol=utils.SMALL).all()
            else:
                eq = expected == value
            if not eq:
                raise AttributeError(f"Expected attribute {attr_name} to have value {expected}, but got {value}!")

    @classmethod
    def from_dict(cls, input_dict: dict[str, Any]) -> "MicArray":
        if "micarray_type" not in input_dict:
            raise KeyError("'micarray_type' key not found in input dict")
        d = deepcopy(input_dict)
        mic_class_str = d.pop("micarray_type", "mic")
        if mic_class_str in MICARRAY_CLASS_MAPPING:
            mic_class = MICARRAY_CLASS_MAPPING[mic_class_str]
        else:
            mic_class = dynamically_define_micarray(micarray_type=mic_class_str, **d)
        mic_obj = mic_class()
        mic_obj.set_absolute_coordinates(d["coordinates_center"])
        for k, v in d.items():
            mic_obj._set_attribute(k, v)
        return mic_obj


@dataclass(repr=False, eq=False)
class MonoCapsule(MicArray):
    """A single mono microphone capsule."""

    name: str = "monocapsule"
    is_spherical: bool = False
    channel_layout_type: str = "mic"

    @property
    def coordinates_cartesian(self) -> np.ndarray:
        return np.array([[0.0, 0.0, 0.0]])

    @property
    def capsule_names(self) -> list[str]:
        return ["mono"]


@dataclass(repr=False, eq=False)
class FOAListener(MicArray):
    """First-order ambisonics listener: one point, 4 AmbiX channels (W, X, Y, Z)."""

    name: str = "foalistener"
    is_spherical: bool = False
    channel_layout_type: str = "foa"

    @property
    def coordinates_cartesian(self) -> np.ndarray:
        return np.array([[0.0, 0.0, 0.0]])

    @property
    def capsule_names(self) -> list[str]:
        return ["w", "x", "y", "z"]


@dataclass(repr=False, eq=False)
class Binaural(MicArray):
    """A binaural listener: one point rendered to 2 channels (left, right).

    With `hrtf_sofa` set to a SimpleFreeFieldHRIR SOFA path, rendering uses
    the measured HRIR set (direct and diffracted paths: the interpolated
    HRIR; stochastic tail: per-band |H_ear|^2; see rir.hrtf). Without a
    file, the analytic Brown-Duda spherical head (rir.sh)."""

    name: str = "binaural"
    is_spherical: bool = False
    channel_layout_type: str = "binaural"
    hrtf_sofa: str = None

    @property
    def coordinates_cartesian(self) -> np.ndarray:
        return np.array([[0.0, 0.0, 0.0]])

    @property
    def capsule_names(self) -> list[str]:
        return ["left", "right"]

    def to_dict(self) -> dict:
        out = super().to_dict()
        if self.hrtf_sofa is not None:
            out["hrtf_sofa"] = str(self.hrtf_sofa)
        return out

    def load_hrtf(self, sample_rate: int, device=None):
        """The measured HRTFSet at `sample_rate` on `device` (default cuda),
        or None where no file is configured. Cached per (path, rate,
        device) in rir.hrtf.load_hrtf_sofa, so repeated renders share one copy."""
        if not self.hrtf_sofa:
            return None
        from audiblelight_tpu_torch.rir.hrtf import load_hrtf_sofa

        return load_hrtf_sofa(str(self.hrtf_sofa), int(sample_rate), device)


@dataclass(repr=False, eq=False)
class HOAListener(MicArray):
    """Higher-order ambisonics listener: one point, ACN/SN3D channels; third
    order (16 channels) by default, channel_layout_type="hoa2" for second
    order (9). The tracer encodes the direct path at min(direct_sh_order,
    layout order) and the tail at min(indirect_sh_order, layout order)."""

    name: str = "hoalistener"
    is_spherical: bool = False
    channel_layout_type: str = "hoa3"

    @property
    def coordinates_cartesian(self) -> np.ndarray:
        return np.array([[0.0, 0.0, 0.0]])

    @property
    def capsule_names(self) -> list[str]:
        return [f"acn{i}" for i in range(self.channel_layout.channel_count)]


@dataclass(repr=False, eq=False)
class AmbeoVR(MicArray):
    """Sennheiser AmbeoVR: 4 cardioid capsules in a tetrahedron, r = 1 cm."""

    name: str = "ambeovr"
    is_spherical: bool = True
    channel_layout_type: str = "mic"

    @property
    def coordinates_polar(self) -> np.ndarray:
        return np.array([[45, 35, 0.01], [-45, -35, 0.01], [135, -35, 0.01], [-135, 35, 0.01]])

    @property
    def coordinates_cartesian(self) -> np.ndarray:
        return utils.polar_to_cartesian(self.coordinates_polar)

    @property
    def capsule_names(self) -> list[str]:
        return ["FLU", "FRD", "BLD", "BRU"]


@dataclass(repr=False, eq=False)
class Eigenmike32(MicArray):
    """mh acoustics Eigenmike em32: 32 capsules on a 4.2 cm-radius sphere."""

    name: str = "eigenmike32"
    is_spherical: bool = True
    channel_layout_type: str = "mic"

    @property
    def coordinates_polar(self) -> np.ndarray:
        # Published capsule angles (EigenStudio manual, section 4.5).
        return np.array(
            [
                [0.0, 21.0, 0.042],
                [32.0, 0.0, 0.042],
                [0.0, -21.0, 0.042],
                [-32.0, 0.0, 0.042],
                [0.0, 58.0, 0.042],
                [45.0, 35.0, 0.042],
                [69.0, 0.0, 0.042],
                [45.0, -35.0, 0.042],
                [0.0, -58.0, 0.042],
                [-45.0, -35.0, 0.042],
                [-69.0, 0.0, 0.042],
                [-45.0, 35.0, 0.042],
                [91.0, 69.0, 0.042],
                [90.0, 32.0, 0.042],
                [90.0, -31.0, 0.042],
                [89.0, -69.0, 0.042],
                [180.0, 21.0, 0.042],
                [-148.0, 0.0, 0.042],
                [180.0, -21.0, 0.042],
                [148.0, 0.0, 0.042],
                [180.0, 58.0, 0.042],
                [-135.0, 35.0, 0.042],
                [-111.0, 0.0, 0.042],
                [-135.0, -35.0, 0.042],
                [180.0, -58.0, 0.042],
                [135.0, -35.0, 0.042],
                [111.0, 0.0, 0.042],
                [135.0, 35.0, 0.042],
                [-91.0, 69.0, 0.042],
                [-90.0, 32.0, 0.042],
                [-90.0, -32.0, 0.042],
                [-89.0, -69.0, 0.042],
            ]
        )

    @property
    def coordinates_cartesian(self) -> np.ndarray:
        return utils.polar_to_cartesian(self.coordinates_polar)

    @property
    def capsule_names(self) -> list[str]:
        return [str(i) for i in range(1, 33)]


@dataclass(repr=False, eq=False)
class Eigenmike64(MicArray):
    """mh acoustics Eigenmike em64: 64 capsules on a 4.2 cm-radius sphere."""

    name: str = "eigenmike64"
    is_spherical: bool = True
    channel_layout_type: str = "mic"

    @property
    def coordinates_polar(self) -> np.ndarray:
        # Published capsule angles (em64 getting-started guide, Table 1).
        return np.array(
            [
                [-162.544, 73.234, 0.042],
                [115.734, 68.032, 0.042],
                [81.911, 47.606, 0.042],
                [-46.641, 76.718, 0.042],
                [43.179, 67.327, 0.042],
                [46.732, 37.308, 0.042],
                [-24.004, 52.194, 0.042],
                [14.54, 46.606, 0.042],
                [-155.545, 46.061, 0.042],
                [-153.458, 19.687, 0.042],
                [-112.678, 56.777, 0.042],
                [-126.183, 29.974, 0.042],
                [-95.456, 33.524, 0.042],
                [99.667, 22.506, 0.042],
                [104.684, -3.274, 0.042],
                [120.923, 41.577, 0.042],
                [126.513, 11.921, 0.042],
                [148.237, 27.931, 0.042],
                [162.638, 51.283, 0.042],
                [178.55, 26.2, 0.042],
                [21.271, 19.805, 0.042],
                [25.783, -6.246, 0.042],
                [47.861, 8.901, 0.042],
                [55.907, -16.094, 0.042],
                [71.429, 22.247, 0.042],
                [78.492, -1.706, 0.042],
                [-66.779, 50.002, 0.042],
                [-69.432, 21.227, 0.042],
                [-41.865, 29.113, 0.042],
                [-25.996, 7.717, 0.042],
                [-7.977, 26.975, 0.042],
                [0.0, 0.206, 0.042],
                [174.033, -47.517, 0.042],
                [-147.28, -49.76, 0.042],
                [-108.082, -45.213, 0.042],
                [150.647, -70.363, 0.042],
                [-119.173, -72.577, 0.042],
                [-66.938, -52.069, 0.042],
                [-28.99, -71.199, 0.042],
                [60.827, -72.577, 0.042],
                [-133.087, -25.536, 0.042],
                [-126.074, 3.741, 0.042],
                [-166.362, -26.016, 0.042],
                [-150.33, -5.331, 0.042],
                [-176.831, -0.064, 0.042],
                [163.71, -21.455, 0.042],
                [156.952, 4.133, 0.042],
                [139.432, -40.84, 0.042],
                [135.973, -12.578, 0.042],
                [102.327, -52.637, 0.042],
                [112.551, -27.032, 0.042],
                [83.146, -27.563, 0.042],
                [-52.292, -25.888, 0.042],
                [-50.861, 0.31, 0.042],
                [-81.748, -28.448, 0.042],
                [-77.026, -3.934, 0.042],
                [-106.853, -16.387, 0.042],
                [-99.931, 8.949, 0.042],
                [59.739, -45.976, 0.042],
                [14.224, -52.677, 0.042],
                [32.49, -30.656, 0.042],
                [-25.925, -43.883, 0.042],
                [2.084, -26.359, 0.042],
                [-24.932, -17.464, 0.042],
            ]
        )

    @property
    def coordinates_cartesian(self) -> np.ndarray:
        return utils.polar_to_cartesian(self.coordinates_polar)

    @property
    def capsule_names(self) -> list[str]:
        return [str(i) for i in range(1, 65)]


MICARRAY_LIST = [Eigenmike32, Eigenmike64, AmbeoVR, MonoCapsule, Binaural, FOAListener, HOAListener]
MICARRAY_CLASS_MAPPING = {cls.__name__: cls for cls in MICARRAY_LIST}


def sanitize_microphone_input(microphone_type: Any) -> Type[MicArray]:
    """A MicArray class from a name, class or instance; None is a MonoCapsule."""
    if microphone_type is None:
        logger.warning("No microphone type provided, using a mono microphone capsule in a random position!")
        return MonoCapsule
    if isinstance(microphone_type, str):
        return get_micarray_from_string(microphone_type)
    if isinstance(microphone_type, type) and issubclass(microphone_type, MicArray):
        return microphone_type
    if isinstance(microphone_type, MicArray):
        return type(microphone_type)
    raise TypeError(f"Could not parse microphone type {type(microphone_type)}")


def get_micarray_from_string(micarray_name: str) -> Type[MicArray]:
    """The rig class whose `name` is `micarray_name`."""
    for ma in MICARRAY_LIST:
        if ma().name == micarray_name:
            return ma
    acceptable = [ma().name for ma in MICARRAY_LIST]
    raise ValueError(f"Cannot find array {micarray_name}: expected one of {', '.join(acceptable)}")


def dynamically_define_micarray(**kwargs) -> Type["MicArray"]:
    """A new MicArray class with the given attributes: a rig known only at
    run time (`MicArray.from_dict` of a type no class has), its capsules
    from `coordinates_cartesian` or `coordinates_polar`, named `micarray_type`."""

    @dataclass(repr=False, eq=False)
    class _DynamicMicArray(MicArray):
        def __init__(self):
            super().__init__()
            self.name = kwargs.get("name", getattr(self, "name", ""))
            self.channel_layout_type = kwargs.get(
                "channel_layout_type", getattr(self, "channel_layout_type", "unknown")
            )
            self.is_spherical = kwargs.get("is_spherical", getattr(self, "is_spherical", False))

        @property
        def coordinates_cartesian(self) -> np.ndarray:
            if kwargs.get("coordinates_cartesian") is not None:
                return np.asarray(kwargs["coordinates_cartesian"], dtype=float)
            if kwargs.get("coordinates_polar") is not None:
                return utils.polar_to_cartesian(
                    np.asarray(kwargs["coordinates_polar"], dtype=float)
                )
            raise NotImplementedError

        @property
        def coordinates_polar(self) -> np.ndarray:
            if kwargs.get("coordinates_polar") is not None:
                return np.asarray(kwargs["coordinates_polar"], dtype=float)
            if kwargs.get("coordinates_cartesian") is not None:
                return utils.cartesian_to_polar(
                    np.asarray(kwargs["coordinates_cartesian"], dtype=float)
                )
            raise NotImplementedError

        @property
        def capsule_names(self) -> list[str]:
            if kwargs.get("capsule_names") is not None:
                return kwargs["capsule_names"]
            # Default names from whichever coordinate set was provided
            coords = kwargs.get("coordinates_cartesian", kwargs.get("coordinates_polar"))
            if coords is not None:
                return [f"capsule{i:03d}" for i in range(len(coords))]
            raise NotImplementedError

    if "micarray_type" in kwargs:
        _DynamicMicArray.__name__ = kwargs["micarray_type"]

    return _DynamicMicArray


def ambeovr_capsules(center) -> np.ndarray:
    """(4, 3) absolute capsule positions of an AmbeoVR centred at `center`."""
    mic = AmbeoVR()
    return mic.set_absolute_coordinates(np.asarray(center, dtype=np.float64))


__all__ = [
    "sanitize_microphone_input",
    "MicArray",
    "Binaural",
    "Eigenmike32",
    "Eigenmike64",
    "MonoCapsule",
    "AmbeoVR",
    "MICARRAY_LIST",
    "FOAListener",
    "HOAListener",
    "dynamically_define_micarray",
    "CHANNEL_LAYOUT_TYPES",
    "ChannelLayout",
    "ChannelLayoutType",
]
