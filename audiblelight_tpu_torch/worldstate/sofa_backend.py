"""Measured-RIR backend (`WorldStateSOFA`): pre-rendered IRs from SOFA files.

Counterpart of audiblelight_tpu/worldstate/sofa_backend.py, on the port's
own SOFA reader (io.sofa over io.hdf5): a dummy microphone is derived from
the file's ListenerShortName and receiver positions; emitters snap to the
nearest measured source position (KD-tree); trajectories are linear or
semicircular paths snapped to the measured grid; `get_irs` reads the rows of
Data.IR the emitters need and resamples them when the file's sample rate
differs. The world state's Generator draws in the reference's order, so the
same seed places the same emitters. The IRs render through the plan path on
`device` (default `cuda`; raises without a card).
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Any, Optional, Union

import numpy as np
from scipy.spatial import KDTree

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.io.audio import resample
from audiblelight_tpu_torch.io.sofa import SOFAFile
from audiblelight_tpu_torch.micarrays import CHANNEL_LAYOUT_TYPES, dynamically_define_micarray
from audiblelight_tpu_torch.utils import logger, resolve_device
from audiblelight_tpu_torch.worldstate.base import Emitter, WorldState


class WorldStateSOFA(WorldState):
    """A WorldState driven by pre-rendered RIRs stored in a .SOFA file."""

    name = "SOFA"

    # When a matched point is further than this (metres), warn loudly
    WARN_WHEN_DISTANCE_EXCEEDS = 0.1

    def __init__(
        self,
        sofa: Union[str, Path],
        sample_rate: Optional[utils.Numeric] = config.SAMPLE_RATE,
        mic_alias: Optional[str] = None,
        seed: Optional[int] = None,
        device=None,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.sofa_path = utils.sanitise_filepath(sofa)
        self.sample_rate = utils.sanitise_positive_number(sample_rate, cast_to=int)
        self.rng = np.random.default_rng(seed)

        # One microphone, inherent to the measured-RIR format
        self.mic_alias = (
            utils.get_default_alias("mic", self.microphones) if mic_alias is None else mic_alias
        )
        self._kdtree = None
        self._source_positions = None
        self._listener_positions = None
        self.ir_read = None  # "rows" or "whole": how the last get_irs read Data.IR
        self._add_dummy_microphone()

    # ------------------------------------------------------------------
    # Microphone handling
    # ------------------------------------------------------------------

    def clear_microphones(self) -> None:
        raise NotImplementedError(
            "It is not possible to clear microphones from a 'WorldStateSOFA' object: the "
            "microphones are defined by the SOFA file itself. Use 'WorldStateRLR' or "
            "'WorldStateShoebox' to control microphone positions explicitly."
        )

    def clear_microphone(self, alias: str) -> None:
        raise NotImplementedError(
            "It is not possible to clear a microphone from a 'WorldStateSOFA' object: the "
            "microphone is defined by the SOFA file itself. Use 'WorldStateRLR' or "
            "'WorldStateShoebox' to control microphone positions explicitly."
        )

    def _infer_channel_layout_name(self, listener_short_name: str) -> str:
        """Infer 'foa'/'mic'/'binaural' from the listener name or filepath."""
        for candidate in CHANNEL_LAYOUT_TYPES:
            if listener_short_name == candidate:
                return candidate
            if candidate in str(self.sofa_path):
                return candidate
        return "unknown"

    def _add_dummy_microphone(self) -> None:
        """Build a microphone array from the SOFA file's receiver positions."""
        with self.sofa() as f:
            attrs = f.get_global_attributes()
            caps_positions = f.receiver_positions

        mic_name = str(attrs.get("ListenerShortName", "unknown")).lower()
        clt = self._infer_channel_layout_name(mic_name)
        capsule_names = [str(i) for i in range(1, caps_positions.shape[0] + 1)]

        marray_cls = dynamically_define_micarray(
            name=mic_name,
            channel_layout_type=clt,
            coordinates_cartesian=caps_positions,
            capsule_names=capsule_names,
        )
        marray = marray_cls()
        marray.set_absolute_coordinates([0.0, 0.0, 0.0])
        self.microphones[self.mic_alias] = marray

    # ------------------------------------------------------------------
    # SOFA access
    # ------------------------------------------------------------------

    def sofa(self) -> SOFAFile:
        """Open the SOFA file (context-manager compatible)."""
        loaded = SOFAFile(self.sofa_path)
        if not loaded.is_valid():
            loaded.close()
            raise ValueError(f"SOFA file at {self.sofa_path} is invalid!")
        return loaded

    def get_source_positions(self) -> np.ndarray:
        """(M, 3) measured source positions (cached)."""
        if self._source_positions is None:
            with self.sofa() as f:
                self._source_positions = f.source_positions
        return self._source_positions

    def get_listener_positions(self) -> np.ndarray:
        """(M, 3) listener positions (cached: `_update` runs per emitter)."""
        if self._listener_positions is None:
            with self.sofa() as f:
                self._listener_positions = f.listener_positions
        return self._listener_positions

    def get_room_min_max(self) -> tuple[np.ndarray, np.ndarray]:
        all_xyz = np.vstack([self.get_source_positions(), self.get_listener_positions()])
        return all_xyz.min(axis=0), all_xyz.max(axis=0)

    # ------------------------------------------------------------------
    # Placement (grid-snapped)
    # ------------------------------------------------------------------

    def get_random_valid_position_idx(self) -> np.ndarray:
        all_positions = self.get_source_positions()
        return np.array([int(self.rng.integers(0, all_positions.shape[0]))])

    def get_nearest_source_idx(self, candidate_position: np.ndarray) -> np.ndarray:
        """Nearest measured-source index for each row of `candidate_position`."""
        candidate_position = np.atleast_2d(np.asarray(candidate_position, dtype=float))
        source_positions = self.get_source_positions()
        if self._kdtree is None:
            self._kdtree = KDTree(source_positions)

        distances, indices = self._kdtree.query(candidate_position, k=1)
        distances = np.atleast_1d(distances)
        indices = np.atleast_1d(indices)
        for point, distance, index in zip(candidate_position, distances, indices):
            if distance >= self.WARN_WHEN_DISTANCE_EXCEEDS:
                logger.error(
                    f"Could not find a match for point {point} within "
                    f"{self.WARN_WHEN_DISTANCE_EXCEEDS} metres. Using nearest point "
                    f"({source_positions[index]}), which is {round(float(distance), 2)}m away."
                )
        return indices

    def _try_add_emitter(self, position, alias: str) -> bool:
        source_positions = self.get_source_positions()
        if position is None:
            position_idx = self.get_random_valid_position_idx()
        else:
            position_idx = self.get_nearest_source_idx(position)

        for idx in position_idx:
            validated = source_positions[int(idx), :]
            if position is not None:
                logger.info(f"Using nearest neighbour position ({validated})")
            self._register_emitter(
                Emitter(
                    alias=alias,
                    coordinates_absolute=utils.sanitise_coordinates(validated),
                    sofa_idx=int(idx),
                ),
                alias,
            )
        return True

    def add_emitter(
        self,
        position=None,
        alias: Optional[str] = None,
        mic: Optional[str] = None,  # unused: one fixed mic
        keep_existing: Optional[bool] = False,
        ensure_direct_path=False,  # unused: measured IRs embed the room
        max_place_attempts=config.MAX_PLACE_ATTEMPTS,  # unused
    ) -> None:
        """Add an emitter snapped to the nearest measured source position."""
        if not keep_existing:
            self.clear_emitters()
        alias = utils.get_default_alias("src", self.emitters) if alias is None else alias
        placed = self._try_add_emitter(position, alias)
        if not placed:
            if position is None:
                raise ValueError("Could not find a valid position for emitter.")
            raise ValueError(f"Position {position} invalid.")
        self._update()

    def add_emitters(
        self,
        positions=None,
        aliases=None,
        mics=None,
        n_emitters: Optional[int] = None,
        keep_existing: Optional[bool] = False,
        ensure_direct_path=False,
        raise_on_error: Optional[bool] = True,
    ) -> None:
        """Add multiple grid-snapped emitters."""
        if not keep_existing:
            self.clear_emitters()
        if positions is not None and n_emitters is not None:
            raise TypeError("Cannot specify both `n_emitters` and `positions`.")
        if n_emitters is not None:
            positions = [None] * int(n_emitters)
        provided = [x for x in [positions, aliases] if x is not None]
        if provided and not utils.check_all_lens_equal(*provided):
            raise ValueError("Expected all inputs to have equal length")
        max_idx = max((len(a) for a in provided), default=0)
        for idx in range(max_idx):
            pos = positions[idx] if positions is not None else None
            al = aliases[idx] if aliases is not None else None
            al = utils.get_default_alias("src", self.emitters) if al is None else al
            self._try_add_emitter(pos, al)
        self._update()

    def get_valid_position(self) -> np.ndarray:
        """A random measured source position."""
        idx = self.get_random_valid_position_idx()[0]
        return self.get_source_positions()[idx]

    def _validate_position(self, pos_abs: np.ndarray) -> bool:
        """Positions are valid when near a measured point."""
        candidate = np.atleast_2d(np.asarray(pos_abs, dtype=float))
        idx = self.get_nearest_source_idx(candidate)
        matched = self.get_source_positions()[idx]
        return bool(
            np.all(np.linalg.norm(candidate - matched, axis=1) < self.WARN_WHEN_DISTANCE_EXCEEDS)
        )

    def get_valid_position_with_max_distance(self, ref: np.ndarray, max_distance: float) -> np.ndarray:
        """Random measured position within `max_distance` of `ref`."""
        source_positions = self.get_source_positions()
        distances = np.linalg.norm(source_positions - np.asarray(ref), axis=1)
        mask = (distances != 0) & (distances <= max_distance)
        valid = source_positions[mask, :]
        if valid.shape[0] == 0:
            raise ValueError(f"No measured positions within {max_distance} m of {ref}")
        return valid[int(self.rng.integers(valid.shape[0])), :]

    @staticmethod
    def _validate_trajectory(
        trajectory: np.ndarray,
        max_distance: utils.Numeric,
        step_distance: utils.Numeric,
        n_points: utils.Numeric,
    ) -> bool:
        """Spatial checks only (the measured room handles acoustics)."""
        if trajectory.shape[0] < 2 or trajectory.shape[0] != n_points:
            return False
        start = trajectory[0]
        distances = np.linalg.norm(trajectory[1:] - start, axis=1)
        if distances[np.argmax(distances)] > max_distance:
            return False
        step_deltas = np.linalg.norm(np.diff(trajectory, axis=0), axis=1)
        if np.any(step_deltas > step_distance + utils.SMALL):
            return False
        return True

    def define_trajectory(
        self,
        duration: utils.Numeric,
        starting_position=None,
        velocity: Optional[utils.Numeric] = config.DEFAULT_EVENT_VELOCITY,
        resolution: Optional[utils.Numeric] = config.DEFAULT_EVENT_RESOLUTION,
        shape: Optional[str] = None,
        max_place_attempts: Optional[utils.Numeric] = config.MAX_PLACE_ATTEMPTS,
        ensure_direct_path=False,  # unused
    ) -> np.ndarray:
        """A trajectory snapped to the measured source grid (linear/semicircular)."""
        n_points = utils.sanitise_positive_number(duration * resolution, cast_to=round) + 1
        if n_points < 2:
            n_points = 2
            logger.warning(
                f"Number of points in trajectory is smaller than 2, clamping to 2. "
                f"Consider increasing `resolution` (currently {resolution:.3f})."
            )
        if shape is None:
            shape = str(self.rng.choice(["linear", "semicircular"]))
        max_distance = utils.sanitise_positive_number(velocity * duration)
        step_limit = velocity / resolution
        source_positions = self.get_source_positions()

        starting_position_idx = None
        if starting_position is not None:
            starting_position_idx = self.get_nearest_source_idx(starting_position)

        for _ in range(int(max_place_attempts)):
            if starting_position is None:
                starting_position_idx = self.get_random_valid_position_idx()
            start_attempt = source_positions[starting_position_idx, :][0]

            try:
                end_attempt = self.get_valid_position_with_max_distance(start_attempt, max_distance)
            except ValueError:
                if starting_position is None:
                    continue
                raise

            if shape == "linear":
                trajectory = utils.generate_linear_trajectory(start_attempt, end_attempt, n_points)
            elif shape == "semicircular":
                trajectory = utils.generate_semicircular_trajectory(start_attempt, end_attempt, n_points)
            else:
                raise ValueError("Only 'linear' and 'semicircular' shapes are supported")

            nearest_idxs = self.get_nearest_source_idx(trajectory)
            trajectory_nearest = source_positions[nearest_idxs, :]
            if self._validate_trajectory(trajectory_nearest, max_distance, step_limit, n_points=n_points):
                return trajectory_nearest

        raise ValueError(
            f"Could not define a valid movement trajectory after {max_place_attempts} attempt(s). "
            f"Consider decreasing `resolution` (currently {resolution}), increasing "
            f"`max_place_attempts`, or decreasing velocity*duration ({max_distance:.3f})."
        )

    def _add_emitters_without_validating(self, emitters, alias: Optional[str]) -> None:
        """Register trajectory points, snapping each to the measured grid."""
        alias = utils.get_default_alias("src", self.emitters) if alias is None else alias
        for coord in emitters:
            coord = utils.sanitise_coordinates(coord)
            sofa_idx = int(self.get_nearest_source_idx(coord)[0])
            self._register_emitter(Emitter(alias=alias, coordinates_absolute=coord, sofa_idx=sofa_idx), alias)
        self._update()

    def path_exists_between_points(self, point_a, point_b) -> bool:
        """Measured IRs embed occlusion; treat all grid points as reachable."""
        return True

    # ------------------------------------------------------------------
    # State refresh + simulation
    # ------------------------------------------------------------------

    def _update(self) -> None:
        if self.num_emitters == 0:
            return
        listener_positions = self.get_listener_positions()
        for emitter_list in self.emitters.values():
            for emitter in emitter_list:
                listener_at_idx = listener_positions[emitter.sofa_idx, :]
                pos = emitter.coordinates_absolute - listener_at_idx
                emitter.coordinates_relative_cartesian[self.mic_alias] = pos
                emitter.coordinates_relative_polar[self.mic_alias] = utils.cartesian_to_polar(pos)
                emitter.has_direct_paths[self.mic_alias] = True

    def _simulation_sanity_check(self) -> None:
        assert self.num_emitters > 0, "Must have added valid emitters before calling `simulate`!"
        assert len(self.microphones) == 1, "Expected only one microphone!"
        assert not any(
            em.sofa_idx is None for lst in self.emitters.values() for em in lst
        ), "All Emitter objects must have corresponding indices in the .SOFA file"

    def simulate(self) -> None:
        """Load (and if needed resample) all required IRs from the SOFA file."""
        self._update()
        self._simulation_sanity_check()
        self._irs = self.get_irs()

    def get_irs(self) -> OrderedDict[str, np.ndarray]:
        """{mic_alias: (n_capsules, n_emitters, n_samples)} float64 IRs from
        Data.IR: only the measurements the emitters use are read (whole
        rows of a contiguous Data.IR; a chunked one is read whole)."""
        required = np.array([em.sofa_idx for lst in self.emitters.values() for em in lst], dtype=np.int64)
        rows, inverse = np.unique(required, return_inverse=True)
        with self.sofa() as f:
            ir_sr = int(f.sampling_rate)
            n_meas, n_rec, n_samples = f.data_shape
            self.ir_read = "rows" if f.ir_layout == "contiguous" else "whole"
            picked = f.read_ir_rows(rows)  # (U, R, N)

        expected_out = round(n_samples * (self.sample_rate / ir_sr))
        final = np.zeros((n_rec, len(required), expected_out))
        for out_idx, row in enumerate(inverse):
            ir = picked[int(row)]  # (R, N)
            if ir_sr != self.sample_rate:
                ir = resample(ir.astype(np.float64), ir_sr, self.sample_rate)
            final[:, out_idx, : ir.shape[1]] = ir[:, :expected_out]

        return OrderedDict({self.mic_alias: final})

    # ------------------------------------------------------------------
    # Serialisation
    # ------------------------------------------------------------------

    def to_dict(self) -> dict:
        with self.sofa() as f:
            sofa_metadata = f.get_global_attributes()
        return dict(
            backend=self.name,
            sofa=str(self.sofa_path),
            sample_rate=self.sample_rate,
            emitters={
                alias: [utils.coerce_nested_inputs(e.coordinates_absolute) for e in lst]
                for alias, lst in self.emitters.items()
            },
            emitter_sofa_idxs={alias: [e.sofa_idx for e in lst] for alias, lst in self.emitters.items()},
            microphones={a: m.to_dict() for a, m in self.microphones.items()},
            metadata={
                "bounds": [utils.coerce_nested_inputs(i) for i in self.get_room_min_max()],
                **sofa_metadata,
            },
        )

    @classmethod
    def from_dict(cls, input_dict: dict[str, Any], device=None) -> "WorldStateSOFA":
        for k in ["emitters", "microphones", "sofa", "metadata", "sample_rate", "emitter_sofa_idxs"]:
            if k not in input_dict:
                raise KeyError(f"Missing key: '{k}'")

        state = cls(
            sofa=input_dict["sofa"],
            mic_alias=str(list(input_dict["microphones"].keys())[0]),
            sample_rate=input_dict["sample_rate"],
            device=device,
        )
        state.emitters = OrderedDict(
            {
                a: [Emitter(alias=a, coordinates_absolute=v1_, sofa_idx=v2_) for (v1_, v2_) in zip(v1, v2)]
                for (a, v1), v2 in zip(input_dict["emitters"].items(), input_dict["emitter_sofa_idxs"].values())
            }
        )
        state._update()
        return state

    def __str__(self) -> str:
        return (
            f"'{self.__class__.__name__}' with SOFA file '{self.sofa_path}' and "
            f"{len(self)} objects ({len(self.microphones)} microphones, {self.num_emitters} emitters)"
        )
