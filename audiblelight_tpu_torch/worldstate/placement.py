"""Placement and trajectories for the geometric world backend.

Copy of audiblelight_tpu/worldstate/placement.py: rejection-sampling
placement of microphones, emitters and moving-event trajectories on top of
two backend primitives, the batched `_get_valid_positions_mask` and
`path_exists_between_points`. Every draw comes from the world state's
numpy Generator, in the reference's order.
"""

from __future__ import annotations

import copy
from typing import Optional, Union

import numpy as np

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.micarrays import MicArray, sanitize_microphone_input
from audiblelight_tpu_torch.utils import logger
from audiblelight_tpu_torch.worldstate.base import Emitter


def _mic_factory(microphone_type):
    """Zero-arg factory for a microphone input: classes and names resolve
    through sanitize_microphone_input; a configured instance is deep-copied
    so its settings survive."""
    if issubclass(type(microphone_type), MicArray):
        return lambda: copy.deepcopy(microphone_type)
    return sanitize_microphone_input(microphone_type)


class PlacementMixin:
    """Mixin for WorldState backends with free geometric placement.

    Requires the host class to provide:
      * ``_get_valid_positions_mask(positions) -> (N,) bool``
      * ``path_exists_between_points(a, b) -> bool``
      * ``bounds`` property -> (2, 3) [min; max]
      * ``rng`` attribute (np.random.Generator)
      * distance attributes ``empty_space_around_*``
    """

    # ------------------------------------------------------------------
    # Random positions
    # ------------------------------------------------------------------

    def get_random_point_inside_bounds(
        self, batch_size: int = config.POINT_BATCH_SIZE
    ) -> np.ndarray:
        """A random valid point, testing `batch_size` candidates per query."""
        min_bound, max_bound = np.asarray(self.bounds)
        for _ in range(config.MAX_PLACE_ATTEMPTS):
            points = self.rng.uniform(min_bound, max_bound, size=(batch_size, 3))
            mask = np.asarray(self._get_valid_positions_mask(points))
            if mask.any():
                valids = np.flatnonzero(mask)
                return points[self.rng.choice(valids)]
        raise ValueError(
            f"Could not sample a valid point after {config.MAX_PLACE_ATTEMPTS} batches"
        )

    def get_valid_position(self) -> np.ndarray:
        """A random valid position (optionally meeting the openness heuristic)."""
        pos = self.get_random_point_inside_bounds()
        if getattr(self, "ensure_minimum_weighted_average_ray_length", False):
            for attempt in range(config.MAX_PLACE_ATTEMPTS):
                if (
                    self.calculate_weighted_average_ray_length(pos)
                    >= self.minimum_weighted_average_ray_length
                ):
                    logger.info(f"Found suitable position after {attempt + 1} attempts")
                    return pos
                pos = self.get_random_point_inside_bounds()
            logger.error(
                f"Could not find a suitable position after {config.MAX_PLACE_ATTEMPTS} "
                f"attempts. Using the last attempted position: {pos}."
            )
        return pos

    def get_valid_position_with_max_distance(
        self,
        ref: np.ndarray,
        r: utils.Numeric,
        n: Optional[utils.Numeric] = config.MAX_PLACE_ATTEMPTS,
    ) -> np.ndarray:
        """Sample a valid position within radius `r` of `ref` (uniform in volume)."""
        r = utils.sanitise_positive_number(r)
        n = utils.sanitise_positive_number(n, cast_to=int)
        ref = utils.sanitise_coordinates(ref)

        directions = self.rng.normal(size=(n, 3))
        directions /= np.linalg.norm(directions, axis=1, keepdims=True)
        radii = r * np.cbrt(self.rng.uniform(0, 1, size=(n,)))
        samples = ref + directions * radii[:, None]

        mask = np.asarray(self._get_valid_positions_mask(samples))
        valid_idxs = np.flatnonzero(mask)
        if len(valid_idxs) == 0:
            raise ValueError(
                f"Cannot generate a random valid point for coordinate {ref} with radius {r:.3f}. "
                f"Consider increasing the number of generated points (currently {n})"
            )
        return samples[self.rng.choice(valid_idxs), :]

    def _validate_position(self, pos_abs: np.ndarray) -> bool:
        """True when every row of `pos_abs` is valid."""
        return bool(np.asarray(self._get_valid_positions_mask(pos_abs)).all())

    def _distance_mask(self, positions: np.ndarray) -> np.ndarray:
        """Object-distance part of the validity mask (emitters, mics, capsules)."""
        positions = utils.coerce2d(positions)
        valid = np.ones(positions.shape[0], dtype=bool)

        if self.emitters:
            emitter_coords = np.vstack(
                [e.coordinates_absolute for lst in self.emitters.values() for e in lst]
            )
            dists = np.linalg.norm(positions[:, None, :] - emitter_coords[None], axis=2)
            valid &= ~np.any(dists < self.empty_space_around_emitter, axis=1)

        if self.microphones:
            for attr, thresh in zip(
                ["coordinates_center", "coordinates_absolute"],
                [self.empty_space_around_mic, self.empty_space_around_capsule],
            ):
                mic_coords = np.vstack(
                    [np.atleast_2d(getattr(m, attr)) for m in self.microphones.values()]
                )
                dists = np.linalg.norm(positions[:, None, :] - mic_coords[None], axis=2)
                valid &= ~np.any(dists < thresh, axis=1)
        return valid

    # ------------------------------------------------------------------
    # Microphones
    # ------------------------------------------------------------------

    def _try_add_microphone(
        self, mic_cls, position: Optional[np.ndarray], alias: str
    ) -> bool:
        """Try to place a microphone; True when successful. `mic_cls` is any
        zero-arg MicArray factory — a class, or a deepcopy factory preserving
        a configured instance (e.g. Binaural(hrtf_sofa=...))."""
        if alias in self.microphones:
            raise KeyError(f"Alias {alias} already exists in microphone dictionary")

        for _ in range(config.MAX_PLACE_ATTEMPTS):
            pos = position if position is not None else self.get_valid_position()
            if len(pos) != 3:
                raise ValueError(f"Expected three coordinates but got {len(pos)}")
            mic = mic_cls()
            mic.set_absolute_coordinates(np.asarray(pos, dtype=float))
            if self._validate_position(np.atleast_2d(mic.coordinates_absolute)):
                self.microphones[alias] = mic
                return True
            if position is not None:
                break
        return False

    def add_microphone(
        self,
        microphone_type=None,
        position=None,
        alias: Optional[str] = None,
        keep_existing: Optional[bool] = True,
    ) -> None:
        """Add a microphone (random valid position unless one is given)."""
        if not keep_existing:
            self.clear_microphones()
        sanitized = _mic_factory(microphone_type)
        alias = utils.get_default_alias("mic", self.microphones) if alias is None else alias
        placed = self._try_add_microphone(sanitized, position, alias)
        if not placed:
            if position is None:
                raise ValueError(
                    f"Could not place microphone after {config.MAX_PLACE_ATTEMPTS} attempts. "
                    f"Consider reducing `empty_space_around` arguments."
                )
            raise ValueError(
                f"Position {position} invalid for microphone {sanitized().name}. "
                f"Consider reducing `empty_space_around` arguments."
            )
        if self.add_to_state:
            self._update()

    def add_microphones(
        self,
        microphone_types=None,
        positions=None,
        aliases=None,
        keep_existing: Optional[bool] = True,
        raise_on_error: Optional[bool] = True,
    ) -> None:
        """Add multiple microphones (list-of-args version of add_microphone)."""
        if not keep_existing:
            self.clear_microphones()
        if aliases is not None and len(set(aliases)) != len(aliases):
            raise ValueError("Only unique aliases can be passed")

        provided = [x for x in [microphone_types, positions, aliases] if x is not None]
        if not utils.check_all_lens_equal(*provided) and provided:
            raise ValueError("Expected all inputs to have equal length")
        max_idx = max((len(a) for a in provided), default=0)

        for idx in range(max_idx):
            mtype = microphone_types[idx] if microphone_types is not None else None
            pos = positions[idx] if positions is not None else None
            al = aliases[idx] if aliases is not None else None
            sanitized = _mic_factory(mtype)
            al = utils.get_default_alias("mic", self.microphones) if al is None else al
            placed = self._try_add_microphone(sanitized, pos, al)
            if not placed:
                msg = (
                    f"Could not place microphone after {config.MAX_PLACE_ATTEMPTS} attempts."
                    if pos is None
                    else f"Position {pos} invalid for microphone {sanitized().name}."
                )
                if raise_on_error:
                    raise ValueError(msg)
                logger.warning(msg)
        if self.add_to_state:
            self._update()

    def add_microphone_and_emitter(
        self,
        position=None,
        polar: Optional[bool] = True,
        microphone_type=None,
        mic_alias: Optional[str] = None,
        emitter_alias: Optional[str] = None,
        keep_existing_mics: Optional[bool] = True,
        keep_existing_emitters: Optional[bool] = True,
        ensure_direct_path: Optional[bool] = True,
        max_place_attempts: Optional[int] = config.MAX_PLACE_ATTEMPTS,
    ) -> None:
        """Add a microphone and an emitter with a fixed relative offset.

        `position` is the emitter offset from the mic: polar (az, el, r) by default
        or cartesian XYZ when polar=False.
        """
        emitter_offset = utils.sanitise_coordinates(position)
        sanitized = _mic_factory(microphone_type)
        if not keep_existing_mics:
            self.clear_microphones()
        if not keep_existing_emitters:
            self.clear_emitters()

        mic_alias = (
            utils.get_default_alias("mic", self.microphones) if mic_alias is None else mic_alias
        )
        emitter_alias = (
            utils.get_default_alias("src", self.emitters)
            if emitter_alias is None
            else emitter_alias
        )
        if polar:
            emitter_offset = utils.polar_to_cartesian(emitter_offset)[0]

        for attempt in range(max_place_attempts):
            mic_pos = self.get_valid_position()
            emitter_pos = mic_pos + emitter_offset
            temp_mic = sanitized()
            temp_mic.set_absolute_coordinates(mic_pos)

            mic_valid = self._validate_position(np.atleast_2d(temp_mic.coordinates_absolute))
            emitter_valid = self._validate_position(emitter_pos)
            direct_ok = (
                self.path_exists_between_points(temp_mic.coordinates_center, emitter_pos)
                if ensure_direct_path
                else True
            )
            if mic_valid and emitter_valid and direct_ok:
                self.microphones[mic_alias] = temp_mic
                self._register_emitter(
                    Emitter(alias=emitter_alias, coordinates_absolute=emitter_pos),
                    emitter_alias,
                )
                logger.info(
                    f"Successfully placed microphone and emitter after {attempt + 1} attempts"
                )
                if self.add_to_state:
                    self._update()
                return
            if (attempt + 1) % 100 == 0:
                logger.info(f"Placement attempt {attempt + 1}/{max_place_attempts}")

        raise ValueError(
            f"Could not place microphone and emitter with specified relationship "
            f"after {max_place_attempts} attempts. Consider reducing the offset distance, "
            f"the `empty_space_around` parameters, or setting `ensure_direct_path=False`."
        )

    # ------------------------------------------------------------------
    # Emitters
    # ------------------------------------------------------------------

    def _try_add_emitter(
        self,
        position: Optional[Union[list, np.ndarray]],
        relative_mic: Optional[MicArray],
        alias: str,
        path_between: list[str],
        max_place_attempts: Optional[utils.Numeric] = config.MAX_PLACE_ATTEMPTS,
    ) -> bool:
        """Try to place one emitter; True when successful."""
        position_is_assigned = position is not None
        for _ in range(1 if position_is_assigned else int(max_place_attempts)):
            pos = position if position_is_assigned else self.get_valid_position()
            if len(pos) != 3:
                raise ValueError(f"Expected three coordinates but got {len(pos)}")
            pos = np.asarray(pos, dtype=float)
            if relative_mic is not None:
                pos = relative_mic.coordinates_center + pos
            if not self._validate_position(pos):
                continue
            if not all(
                self.path_exists_between_points(pos, self.microphones[d].coordinates_center)
                for d in path_between
            ):
                continue
            self._register_emitter(
                Emitter(alias=alias, coordinates_absolute=utils.sanitise_coordinates(pos)),
                alias,
            )
            return True
        return False

    def add_emitter(
        self,
        position=None,
        alias: Optional[str] = None,
        mic: Optional[str] = None,
        keep_existing: Optional[bool] = False,
        ensure_direct_path: Optional[Union[bool, list, str]] = False,
        max_place_attempts: Optional[utils.Numeric] = config.MAX_PLACE_ATTEMPTS,
    ) -> None:
        """Add an emitter (absolute `position`, or relative to microphone `mic`)."""
        if not keep_existing:
            self.clear_emitters()
        direct_path_to = self._parse_valid_microphone_aliases(ensure_direct_path)
        desired_mic = self.get_microphone(mic) if mic is not None else None
        alias = utils.get_default_alias("src", self.emitters) if alias is None else alias

        placed = self._try_add_emitter(
            position, desired_mic, alias, direct_path_to, max_place_attempts
        )
        if not placed:
            if position is None:
                raise ValueError(
                    f"Could not place emitter after {max_place_attempts} attempts. "
                    f"Consider reducing the number of `emitters` or the `empty_space_around` arguments."
                )
            raise ValueError(
                f"Position {position} invalid when placing emitter! "
                f"Consider reducing the number of `emitters` or the `empty_space_around` arguments."
            )
        if self.add_to_state:
            self._update()

    def add_emitters(
        self,
        positions=None,
        aliases=None,
        mics=None,
        n_emitters: Optional[int] = None,
        keep_existing: Optional[bool] = False,
        ensure_direct_path: Optional[Union[bool, list, str]] = False,
        raise_on_error: Optional[bool] = True,
    ) -> None:
        """Add multiple emitters; `n_emitters` places that many at random."""
        if not keep_existing:
            self.clear_emitters()
        direct_path_to = self._parse_valid_microphone_aliases(ensure_direct_path)

        if positions is not None and n_emitters is not None:
            raise TypeError("Cannot specify both `n_emitters` and `positions`.")
        if n_emitters is not None:
            if not isinstance(n_emitters, int) or n_emitters <= 0:
                raise ValueError("`n_emitters` must be a positive integer!")
            positions = [None] * n_emitters

        provided = [
            x for x in [positions, aliases, mics] if x is not None and isinstance(x, (list, np.ndarray))
        ]
        if provided and not utils.check_all_lens_equal(*provided):
            raise ValueError("Expected all inputs to have equal length")
        max_idx = max((len(a) for a in provided), default=0)
        if isinstance(mics, str):
            mics = [mics] * max_idx

        for idx in range(max_idx):
            pos = positions[idx] if positions is not None else None
            al = aliases[idx] if aliases is not None else None
            mic_al = mics[idx] if mics is not None else None
            desired_mic = self.get_microphone(mic_al) if mic_al is not None else None
            al = utils.get_default_alias("src", self.emitters) if al is None else al
            placed = self._try_add_emitter(pos, desired_mic, al, direct_path_to)
            if not placed and raise_on_error:
                msg = (
                    f"Could not place emitter after {config.MAX_PLACE_ATTEMPTS} attempts."
                    if pos is None
                    else f"Position {pos} invalid for emitter."
                )
                raise ValueError(msg)
        if self.add_to_state:
            self._update()

    def _add_emitters_without_validating(
        self, emitters: Union[list, np.ndarray], alias: Optional[str]
    ) -> None:
        """Register pre-validated emitters (e.g. trajectory points) directly."""
        alias = utils.get_default_alias("src", self.emitters) if alias is None else alias
        for coord in emitters:
            self._register_emitter(
                Emitter(alias=alias, coordinates_absolute=utils.sanitise_coordinates(coord)),
                alias,
            )
        if self.add_to_state:
            self._update()

    # ------------------------------------------------------------------
    # Trajectories
    # ------------------------------------------------------------------

    def _validate_trajectory(
        self,
        trajectory: np.ndarray,
        max_distance: utils.Numeric,
        step_distance: utils.Numeric,
        n_points: utils.Numeric,
        requires_direct_line_between_start_and_end: bool,
        ensure_direct_path_to_mic: Optional[list[str]] = None,
    ) -> bool:
        """Validate a candidate trajectory against spatial + visibility limits."""
        if trajectory.shape[0] < 2 or trajectory.shape[0] != n_points:
            return False
        if ensure_direct_path_to_mic is None:
            ensure_direct_path_to_mic = []

        start = trajectory[0]
        distances = np.linalg.norm(trajectory[1:] - start, axis=1)

        for d in ensure_direct_path_to_mic:
            mic_center = self.microphones[d].coordinates_center
            if not all(self.path_exists_between_points(t, mic_center) for t in trajectory):
                return False

        # The furthest point from the start bounds travel distance (random walks
        # can wander out and return, so the last point is not enough).
        max_idx = np.argmax(distances)
        if distances[max_idx] > max_distance:
            return False
        end = trajectory[max_idx + 1]

        if requires_direct_line_between_start_and_end and not self.path_exists_between_points(
            start, end
        ):
            return False

        step_deltas = np.linalg.norm(np.diff(trajectory, axis=0), axis=1)
        if np.any(step_deltas > step_distance + utils.SMALL):
            return False

        return self._validate_position(trajectory)

    def define_trajectory(
        self,
        duration: utils.Numeric,
        starting_position=None,
        velocity: Optional[utils.Numeric] = config.DEFAULT_EVENT_VELOCITY,
        resolution: Optional[utils.Numeric] = config.DEFAULT_EVENT_RESOLUTION,
        shape: Optional[str] = None,
        max_place_attempts: Optional[utils.Numeric] = config.MAX_PLACE_ATTEMPTS,
        ensure_direct_path: Optional[Union[bool, list, str]] = False,
    ) -> np.ndarray:
        """Define a valid (n_points, 3) trajectory for a moving sound event."""
        n_points = utils.sanitise_positive_number(duration * resolution, cast_to=round) + 1
        if n_points < 2:
            n_points = 2
            logger.warning(
                f"Number of points in trajectory is smaller than 2, clamping to 2. "
                f"Consider increasing `resolution` (currently {resolution:.3f})."
            )

        if shape is None:
            shape = str(self.rng.choice(config.MOVING_EVENT_SHAPES))
        max_distance = utils.sanitise_positive_number(velocity * duration)
        step_limit = velocity / resolution

        if starting_position is not None:
            starting_position = utils.sanitise_coordinates(starting_position)
            if not self._validate_position(starting_position):
                raise ValueError(f"Invalid starting position ({starting_position})")

        direct_path_to = self._parse_valid_microphone_aliases(ensure_direct_path)

        for _ in range(int(max_place_attempts)):
            start_attempt = (
                self.get_valid_position() if starting_position is None else starting_position
            )

            if shape == "random":
                end_attempt = None
            else:
                try:
                    end_attempt = self.get_valid_position_with_max_distance(
                        start_attempt, max_distance, max_place_attempts
                    )
                except ValueError:
                    if starting_position is None:
                        continue
                    raise

            if shape == "linear":
                trajectory = utils.generate_linear_trajectory(start_attempt, end_attempt, n_points)
            elif shape == "semicircular":
                trajectory = utils.generate_semicircular_trajectory(
                    start_attempt, end_attempt, n_points
                )
            elif shape == "sine":
                trajectory = utils.generate_sinusoidal_trajectory(
                    start_attempt, end_attempt, n_points, rng=self.rng
                )
            elif shape == "sawtooth":
                trajectory = utils.generate_sawtooth_trajectory(
                    start_attempt, end_attempt, n_points, rng=self.rng
                )
            elif shape == "random":
                trajectory = utils.generate_random_trajectory(
                    start_attempt, step_limit, n_points, rng=self.rng
                )
            else:
                from audiblelight_tpu_torch.worldstate import VALID_MOVING_EVENT_TRAJECTORIES

                raise ValueError(
                    f"`shape` must be one of {', '.join(VALID_MOVING_EVENT_TRAJECTORIES)} "
                    f"but got '{shape}'"
                )

            if self._validate_trajectory(
                trajectory,
                max_distance,
                step_limit,
                n_points=n_points,
                requires_direct_line_between_start_and_end=(shape == "linear"),
                ensure_direct_path_to_mic=direct_path_to,
            ):
                return trajectory

        raise ValueError(
            f"Could not define a valid movement trajectory after {max_place_attempts} attempt(s). "
            f"Consider reducing `empty_space_around` parameters, decreasing `resolution` "
            f"(currently {resolution}), increasing `max_place_attempts` "
            f"(currently {max_place_attempts}), or decreasing velocity*duration "
            f"(currently {max_distance:.3f})."
        )
