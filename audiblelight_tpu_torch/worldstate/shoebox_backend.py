"""The parametric shoebox backend (`WorldStateShoebox`): image-source rooms.

Counterpart of audiblelight_tpu/worldstate/shoebox_backend.py: a rectangular
room with per-wall (optionally per-band) absorption, the placement and
trajectory logic of the mesh backend (its validity test and line of sight
in closed form, since the room is a convex box), and IRs from the
image-source engine (rir.image_source) on the world state's device.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Optional, Union

import numpy as np
import torch

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.geometry.mesh import box_mesh
from audiblelight_tpu_torch.micarrays import MicArray
from audiblelight_tpu_torch.rir.image_source import shoebox_rirs
from audiblelight_tpu_torch.rir.materials import get_material_absorption, octave_band_centers
from audiblelight_tpu_torch.utils import resolve_device
from audiblelight_tpu_torch.worldstate.base import Emitter, WorldState
from audiblelight_tpu_torch.worldstate.placement import PlacementMixin

WALL_ORDER = ["x0", "xL", "y0", "yL", "z0", "zL"]
# Image-source encoding of each one-point rig layout; any other is binaural
SHOEBOX_ENCODINGS = {"foa": "foa", "hoa2": "sh2", "hoa3": "sh3"}


class WorldStateShoebox(PlacementMixin, WorldState):
    """A world state simulating a parametric rectangular ("shoebox") room.

    Arguments as the reference's; `device` is where the IRs are computed
    (default `cuda`; raises without a card).
    """

    name = "SHOEBOX"

    def __init__(
        self,
        dimensions: Union[list, np.ndarray] = (6.0, 4.0, 3.0),
        sample_rate: Optional[utils.Numeric] = config.SAMPLE_RATE,
        absorption: Union[float, dict, list, np.ndarray, str] = 0.3,
        max_order: int = 12,
        max_ir_length: Optional[float] = config.MAX_IR_SECONDS,
        frequency_bands: int = config.RAY_TRACER_FREQUENCY_BANDS,
        empty_space_around_mic: Optional[utils.Numeric] = config.EMPTY_SPACE_AROUND_MIC,
        empty_space_around_emitter: Optional[utils.Numeric] = config.EMPTY_SPACE_AROUND_EMITTER,
        empty_space_around_surface: Optional[utils.Numeric] = config.EMPTY_SPACE_AROUND_SURFACE,
        empty_space_around_capsule: Optional[utils.Numeric] = config.EMPTY_SPACE_AROUND_CAPSULE,
        add_to_context: Optional[bool] = True,
        seed: Optional[int] = None,
        device=None,
    ):
        """`dimensions` (Lx, Ly, Lz) in metres, the room spanning [0, L] per
        axis; `absorption` a scalar alpha for every wall, a material name, a
        (6,) per-wall array (order x0, xL, y0, yL, z0, zL), a (6, B)
        per-wall-per-band array, or a dict {wall name: alpha | material
        name}; `max_order` the image order per axis."""
        super().__init__()
        self.device = resolve_device(device)
        self.add_to_state = add_to_context
        self.sample_rate = utils.sanitise_positive_number(sample_rate, cast_to=int)
        self.rng = np.random.default_rng(seed)

        self.dimensions = np.asarray(dimensions, dtype=float)
        if self.dimensions.shape != (3,) or np.any(self.dimensions <= 0):
            raise ValueError(f"Expected 3 positive room dimensions, got {dimensions}")

        self.max_order = int(max_order)
        self.max_ir_length = float(max_ir_length)
        self.frequency_bands = int(frequency_bands)
        self.band_freqs = octave_band_centers(self.frequency_bands)
        self.absorption_input = absorption
        self.absorption = self._parse_absorption(absorption)  # (6, B)

        self.empty_space_around_mic = utils.sanitise_positive_number(empty_space_around_mic)
        self.empty_space_around_surface = utils.sanitise_positive_number(empty_space_around_surface)
        self.empty_space_around_emitter = utils.sanitise_positive_number(empty_space_around_emitter)
        self.empty_space_around_capsule = utils.sanitise_positive_number(empty_space_around_capsule)

        # The box as a mesh keeps the Scene's mesh surface that of the mesh backend
        self.mesh = box_mesh(extents=self.dimensions, center=self.dimensions / 2)
        self.waypoints = []
        self.ctx = None

    def _parse_absorption(self, absorption) -> np.ndarray:
        """Any accepted absorption spec as a (6, B) array."""
        b = self.frequency_bands
        if isinstance(absorption, str):
            return np.tile(get_material_absorption(absorption, self.band_freqs)[None, :], (6, 1))
        if isinstance(absorption, dict):
            rows = []
            for wall in WALL_ORDER:
                v = absorption.get(wall, 0.3)
                rows.append(get_material_absorption(v, self.band_freqs) if isinstance(v, str) else np.full(b, float(v)))
            return np.stack(rows)
        arr = np.asarray(absorption, dtype=float)
        if arr.ndim == 0:
            return np.full((6, b), float(arr))
        if arr.ndim == 1:
            if arr.shape[0] != 6:
                raise ValueError("Per-wall absorption must have 6 entries")
            return np.tile(arr[:, None], (1, b))
        if arr.shape[0] != 6:
            raise ValueError("Per-wall-per-band absorption must be (6, B)")
        return arr

    # ------------------------------------------------------------------
    # Geometry (closed form: the room is a box)
    # ------------------------------------------------------------------

    @property
    def bounds(self) -> np.ndarray:
        return np.stack([np.zeros(3), self.dimensions])

    def _get_valid_positions_mask(self, pos_abs: np.ndarray) -> np.ndarray:
        positions = utils.coerce2d(np.asarray(pos_abs, dtype=np.float64))
        if positions.shape[1] != 3:
            raise ValueError("Expected input to have shape (N, 3) for XYZ coordinates")
        valid = self._distance_mask(positions)
        margin = self.empty_space_around_surface
        valid &= np.all(positions >= margin, axis=1)
        valid &= np.all(positions <= self.dimensions - margin, axis=1)
        return valid

    def path_exists_between_points(self, point_a, point_b) -> bool:
        """A shoebox is convex: any two points inside it see each other."""
        return all(np.all(p >= 0) and np.all(p <= self.dimensions)
                   for p in (np.asarray(point_a, dtype=float), np.asarray(point_b, dtype=float)))

    def _update(self) -> None:
        self._update_relative_coordinates()

    # ------------------------------------------------------------------
    # Simulation
    # ------------------------------------------------------------------

    def _simulation_sanity_check(self) -> None:
        assert self.num_emitters > 0, "Must have added valid emitters before calling `simulate`!"
        assert len(self.microphones) > 0, "Must have added microphones before calling `simulate`!"

    def simulate(self) -> None:
        """Compute the image-source IRs of every (microphone, emitter) pair."""
        self._update()
        self._simulation_sanity_check()
        self._irs = self.get_irs()

    def _emitter_positions(self) -> np.ndarray:
        coords = [e.coordinates_absolute for lst in self.emitters.values() for e in lst]
        return np.stack(coords) if coords else np.zeros((0, 3))

    def get_irs(self) -> "OrderedDict[str, torch.Tensor]":
        """{mic alias: (C_out, n_emitters, n_samples)} IRs on the world
        state's device (also kept on each mic as `mic.irs`): every capsule
        of a "mic" rig omni, the other rigs encoded at their centre."""
        f32 = dict(dtype=torch.float32, device=self.device)
        log_beta = torch.as_tensor(np.log(np.sqrt(np.clip(1.0 - self.absorption, 1e-6, 1.0))), **f32)
        sources = torch.as_tensor(self._emitter_positions(), **f32)
        n_samples = int(round(self.max_ir_length * self.sample_rate))
        out = OrderedDict()
        for alias, mic in self.microphones.items():
            if mic.channel_layout_type == "mic":
                points, encoding = mic.coordinates_absolute, "omni"
            else:
                points = mic.coordinates_center
                encoding = SHOEBOX_ENCODINGS.get(mic.channel_layout_type, "binaural")
            # A binaural head with `hrtf_sofa` renders through its measured set
            hrtf = (mic.load_hrtf(self.sample_rate, self.device)
                    if encoding == "binaural" and getattr(mic, "hrtf_sofa", None) else None)
            irs = shoebox_rirs(
                torch.as_tensor(self.dimensions, **f32), sources,
                torch.as_tensor(utils.coerce2d(points), **f32), log_beta,
                torch.as_tensor(self.band_freqs, **f32), n_samples=n_samples, max_order=self.max_order,
                sr=self.sample_rate, encoding=encoding, hrtf=hrtf,
            )
            mic.irs = out[alias] = irs
        return out

    # ------------------------------------------------------------------
    # Serialisation
    # ------------------------------------------------------------------

    def to_dict(self) -> dict:
        return dict(
            backend=self.name,
            sample_rate=self.sample_rate,
            dimensions=self.dimensions.tolist(),
            absorption=utils.coerce_nested_inputs(self.absorption),
            max_order=self.max_order,
            max_ir_length=self.max_ir_length,
            frequency_bands=self.frequency_bands,
            emitters={
                alias: [utils.coerce_nested_inputs(e.coordinates_absolute) for e in lst]
                for alias, lst in self.emitters.items()
            },
            microphones={a: m.to_dict() for a, m in self.microphones.items()},
            empty_space_around_mic=self.empty_space_around_mic,
            empty_space_around_emitter=self.empty_space_around_emitter,
            empty_space_around_surface=self.empty_space_around_surface,
            empty_space_around_capsule=self.empty_space_around_capsule,
        )

    @classmethod
    def from_dict(cls, input_dict: dict[str, Any], device=None) -> "WorldStateShoebox":
        for k in ["dimensions", "emitters", "microphones", "sample_rate"]:
            if k not in input_dict:
                raise KeyError(f"Missing key: '{k}'")
        state = cls(
            dimensions=input_dict["dimensions"],
            sample_rate=input_dict["sample_rate"],
            absorption=np.asarray(input_dict["absorption"]),
            max_order=input_dict.get("max_order", 12),
            max_ir_length=input_dict.get("max_ir_length", config.MAX_IR_SECONDS),
            frequency_bands=input_dict.get("frequency_bands", config.RAY_TRACER_FREQUENCY_BANDS),
            empty_space_around_mic=input_dict.get("empty_space_around_mic", config.EMPTY_SPACE_AROUND_MIC),
            empty_space_around_emitter=input_dict.get("empty_space_around_emitter",
                                                      config.EMPTY_SPACE_AROUND_EMITTER),
            empty_space_around_surface=input_dict.get("empty_space_around_surface",
                                                      config.EMPTY_SPACE_AROUND_SURFACE),
            empty_space_around_capsule=input_dict.get("empty_space_around_capsule",
                                                      config.EMPTY_SPACE_AROUND_CAPSULE),
            device=device,
        )
        state.microphones = OrderedDict({a: MicArray.from_dict(v) for a, v in input_dict["microphones"].items()})
        state.emitters = OrderedDict(
            {a: [Emitter(alias=a, coordinates_absolute=v_) for v_ in v] for a, v in input_dict["emitters"].items()}
        )
        state._update()
        return state

    def __str__(self) -> str:
        return (
            f"'{self.__class__.__name__}' with dimensions {self.dimensions.tolist()} and "
            f"{len(self)} objects ({len(self.microphones)} microphones, {self.num_emitters} emitters)"
        )
