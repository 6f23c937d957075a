"""Scene: the top-level API of the port.

Copy of audiblelight_tpu/core.py for the SELD dataset path: the Scene holds a
ray-traced world state (mesh room + microphone + emitters), Events and an
Ambience, places events by rejection sampling with the reference's draws
(Python `random`, numpy's global stream through scipy `rvs`, the world
state's Generator), renders through the fused renderer on the world state's
device, writes per-mic int16 WAVs, the metadata JSON and DCASE CSVs, and
round-trips through to_dict / from_dict / from_json.

Not ported (raise; ROADMAP): the shoebox and SOFA backends, event
augmentations, predefined-trajectory events, images, video and acoustic
imaging.
"""

from __future__ import annotations

import json
import random
from collections import OrderedDict
from datetime import datetime
from pathlib import Path
from typing import Any, Iterator, Optional, Union

import numpy as np
from scipy import stats

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.ambience import Ambience
from audiblelight_tpu_torch.class_mappings import (
    ClassMapping,
    TClassMapping,
    infer_id_and_label_from_inputs,
    sanitize_class_mapping,
)
from audiblelight_tpu_torch.event import Event
from audiblelight_tpu_torch.io.audio import wav_write
from audiblelight_tpu_torch.micarrays import MicArray, _compare_dicts
from audiblelight_tpu_torch.utils import logger
from audiblelight_tpu_torch.worldstate import Emitter, WorldState, get_worldstate_from_string

__version__ = "0.1.0"


class Scene:
    """The highest-level object: a world, its microphones, events, and ambience."""

    def __init__(
        self,
        duration: utils.Numeric,
        backend: Union[str, "WorldState"],
        sample_rate: Optional[utils.Numeric] = config.SAMPLE_RATE,
        fg_path: Optional[Union[str, Path]] = None,
        bg_path: Optional[Union[str, Path]] = None,
        image_path: Optional[Union[str, Path]] = None,
        allow_duplicate_audios: bool = True,
        allow_same_class_events: bool = True,
        ref_db: Optional[utils.Numeric] = config.DEFAULT_REF_DB,
        scene_start_dist: Optional[Any] = None,
        event_start_dist: Optional[Any] = None,
        event_duration_dist: Optional[Any] = None,
        event_velocity_dist: Optional[Any] = None,
        event_resolution_dist: Optional[Any] = None,
        snr_dist: Optional[Any] = None,
        max_overlap: Optional[utils.Numeric] = config.MAX_OVERLAP,
        event_augmentations=None,
        backend_kwargs: Optional[dict] = None,
        class_mapping: Optional[Union[TClassMapping, dict, str]] = "DCASE2023Task3",
        device=None,
    ):
        """Initialise the Scene.

        `backend` is "rlr" or a WorldStateRLR instance; `fg_path` / `bg_path`
        are recursively listed audio folders; the `*_dist` arguments are
        distribution-like objects sampled for each added event;
        `backend_kwargs` pass through to the WorldState constructor. `device`
        is where the world state's queries and the render run (default
        `cuda`; raises without a card). `image_path` and
        `event_augmentations` must be None.
        """
        self.duration = utils.sanitise_positive_number(duration)
        if self.duration < config.WARN_WHEN_SCENE_DURATION_BELOW:
            logger.warning(
                f"The duration for this Scene is very short ({duration:.2f} seconds). "
                f"Events may overlap or be truncated; consider at least "
                f"{config.WARN_WHEN_SCENE_DURATION_BELOW} seconds."
            )
        self.ref_db = self._sanitise_ref_db(ref_db)
        self.max_overlap = utils.sanitise_positive_number(max_overlap, cast_to=int)
        self.sample_rate = utils.sanitise_positive_number(sample_rate, cast_to=int)

        if backend_kwargs is None:
            backend_kwargs = {}
        if image_path is not None or event_augmentations:
            raise NotImplementedError(
                "event images and augmentations are not ported (ROADMAP: augmentations, imaging and video)"
            )

        if isinstance(backend, str):
            desired_state = get_worldstate_from_string(backend)
            utils.validate_kwargs(desired_state.__init__, **backend_kwargs)
            self.state = desired_state(sample_rate=self.sample_rate, device=device, **backend_kwargs)
        elif issubclass(type(backend), WorldState):
            be_sr = getattr(backend, "sample_rate", None)
            if not be_sr or be_sr != self.sample_rate:
                raise ValueError(
                    f"Mismatching backend sample rate: expected {self.sample_rate}, got {be_sr}"
                )
            self.state = backend
        else:
            raise TypeError(
                f"Expected 'backend' to be a string or an *instance* of WorldState subclass, "
                f"but got {type(backend)} instead."
            )

        self.mesh = self.state.mesh

        # Default distributions for event parameters
        if scene_start_dist is None:
            scene_start_dist = stats.uniform(0.0, max(self.duration - 1, 0.0))
        if event_velocity_dist is None:
            event_velocity_dist = stats.uniform(
                config.MIN_EVENT_VELOCITY, config.MAX_EVENT_VELOCITY - config.MIN_EVENT_VELOCITY
            )
        if event_resolution_dist is None:
            event_resolution_dist = stats.uniform(
                config.MIN_EVENT_RESOLUTION,
                config.MAX_EVENT_RESOLUTION - config.MIN_EVENT_RESOLUTION,
            )
        if snr_dist is None:
            snr_dist = stats.uniform(config.MIN_EVENT_SNR, config.MAX_EVENT_SNR - config.MIN_EVENT_SNR)

        self.scene_start_dist = utils.sanitise_distribution(scene_start_dist)
        self.event_start_dist = utils.sanitise_distribution(event_start_dist)
        self.event_duration_dist = utils.sanitise_distribution(event_duration_dist)
        self.event_velocity_dist = utils.sanitise_distribution(event_velocity_dist)
        self.event_resolution_dist = utils.sanitise_distribution(event_resolution_dist)
        self.snr_dist = utils.sanitise_distribution(snr_dist)

        self.fg_paths = self._parse_input_directories(fg_path) if fg_path is not None else []
        self.fg_audios = self._introspect_input_directories(self.fg_paths)
        self.bg_paths = self._parse_input_directories(bg_path) if bg_path is not None else []
        self.bg_audios = self._introspect_input_directories(self.bg_paths)

        self.allow_duplicate_audios = allow_duplicate_audios
        self.allow_same_class_events = allow_same_class_events

        self.events: OrderedDict[str, Event] = OrderedDict()

        self.event_augmentations = []
        self.ambience: OrderedDict[str, Ambience] = OrderedDict()
        self.audio: OrderedDict[str, np.ndarray] = OrderedDict()
        self.class_mapping = sanitize_class_mapping(class_mapping)

    # ------------------------------------------------------------------
    # Sanitisers
    # ------------------------------------------------------------------

    @staticmethod
    def _sanitise_ref_db(ref_db: Any) -> int:
        """Validate the noise floor (dB); warn loudly when positive."""
        if not isinstance(ref_db, utils.NUMERIC_DTYPES):
            raise TypeError(f"Expected `ref_db` to be numeric, but got {type(ref_db)}")
        if ref_db > 0:
            logger.error(
                f"Provided noise floor is positive; expect clipping to occur (ref_db={ref_db:.2f})"
            )
        return int(ref_db)

    @staticmethod
    def _parse_input_directories(input_dir) -> list[Path]:
        """Validate a directory (or list) into a list of Path objects."""
        if not isinstance(input_dir, list):
            input_dir = [input_dir]
        return utils.sanitise_directories(input_dir)

    @staticmethod
    def _introspect_input_directories(
        audio_dir: list[Path], exts: tuple = utils.AUDIO_EXTS
    ) -> list[Path]:
        """Recursively collect files with the given extensions."""
        input_paths = []
        for ext in exts:
            for fg in audio_dir:
                input_paths.extend(fg.rglob(f"*.{ext}"))
        return utils.sanitise_filepaths(input_paths)

    # ------------------------------------------------------------------
    # Dunder
    # ------------------------------------------------------------------

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Scene):
            return False
        return _compare_dicts(self.to_dict(), other.to_dict(), exclude=("creation_time",))

    def __len__(self) -> int:
        return len(self.events)

    def __str__(self) -> str:
        mesh_name = (
            self.state.mesh.metadata.get("fpath", "?") if self.state.mesh is not None else "?"
        )
        return (
            f"'Scene' with mesh '{mesh_name}': {len(self)} events, "
            f"{len(self.state.microphones)} microphones, {self.state.num_emitters} emitters."
        )

    def __repr__(self) -> str:
        return utils.repr_as_json(self)

    def __getitem__(self, alias_or_idx: Union[str, int]) -> Event:
        return self.get_event(alias_or_idx)

    def __iter__(self) -> Iterator[Event]:
        yield from self.get_events()

    # ------------------------------------------------------------------
    # WorldState aliases
    # ------------------------------------------------------------------

    def add_microphone(self, **kwargs) -> None:
        """Alias for `WorldState.add_microphone`."""
        utils.validate_kwargs(self.state.add_microphone, **kwargs)
        self.state.add_microphone(**kwargs)

    def add_microphones(self, **kwargs) -> None:
        """Alias for `WorldState.add_microphones`."""
        utils.validate_kwargs(self.state.add_microphones, **kwargs)
        self.state.add_microphones(**kwargs)

    def add_microphone_and_emitter(self, **kwargs) -> None:
        """Alias for `WorldState.add_microphone_and_emitter`."""
        utils.validate_kwargs(self.state.add_microphone_and_emitter, **kwargs)
        self.state.add_microphone_and_emitter(**kwargs)

    def add_emitter(self, **kwargs) -> None:
        """Alias for `WorldState.add_emitter` (prefer `Scene.add_event`)."""
        logger.warning(
            "Adding an Emitter directly to the WorldState is not recommended. Instead, use "
            "`Scene.add_event`, which will create an Event and add any required Emitters."
        )
        utils.validate_kwargs(self.state.add_emitter, **kwargs)
        self.state.add_emitter(**kwargs)

    def add_emitters(self, **kwargs) -> None:
        """Alias for `WorldState.add_emitters` (prefer `Scene.add_event`)."""
        logger.warning(
            "Adding Emitters directly to the WorldState is not recommended. Instead, use "
            "`Scene.add_event`, which will create Events and add any required Emitters."
        )
        utils.validate_kwargs(self.state.add_emitters, **kwargs)
        self.state.add_emitters(**kwargs)

    # ------------------------------------------------------------------
    # Ambience
    # ------------------------------------------------------------------

    def add_ambience(
        self,
        filepath: Optional[Union[str, Path]] = None,
        noise: Optional[Union[str, utils.Numeric]] = None,
        channels: Optional[int] = None,
        ref_db: Optional[utils.Numeric] = None,
        alias: Optional[str] = None,
        **kwargs,
    ) -> None:
        """Add ambient noise (a colour/exponent, or an audio file) to the Scene.

        When `channels` is omitted it is inferred from the microphones added to
        the state (all must agree on capsule count for mesh backends).
        """
        if channels is None:
            if len(self.state.microphones) == 0:
                raise ValueError(
                    "Cannot infer Ambience channels when no microphones have been added "
                    "to the WorldState."
                )
            if self.state.name.upper() in ("RLR", "SHOEBOX"):
                available = [mic.n_capsules for mic in self.state.microphones.values()]
                if not all(a == available[0] for a in available):
                    raise ValueError(
                        "Cannot infer Ambience channels when available microphones have "
                        "different number of capsules"
                    )
                channels = available[0]
            else:
                channels = list(self.state.microphones.values())[0].n_capsules

        alias = utils.get_default_alias("ambience", self.ambience) if alias is None else alias
        if alias in self.ambience:
            raise KeyError(f"Ambience with alias '{alias}' has already been added to the Scene!")

        if noise is None:
            if filepath is None:
                filepath = self._get_random_audio(self.bg_audios)
            else:
                filepath = utils.sanitise_filepath(filepath)
            if not self.allow_duplicate_audios:
                if filepath in self._get_used_audios():
                    raise ValueError(
                        f"Audio file {filepath.resolve()} has already been added to the Scene. "
                        f"Either increase the number of `bg_paths` in Scene.__init__, choose a "
                        f"different audio file, or set `Scene.allow_duplicate_audios=True`."
                    )

        self.ambience[alias] = Ambience(
            channels=channels,
            duration=self.duration,
            sample_rate=self.sample_rate,
            noise=noise,
            filepath=filepath,
            alias=alias,
            ref_db=ref_db if ref_db is not None else self.ref_db,
            **kwargs,
        )

    # ------------------------------------------------------------------
    # Event helpers
    # ------------------------------------------------------------------

    def _get_used_audios(self) -> list[Path]:
        """Audio files used by all current Ambience and Event objects."""
        events_ambs = self.get_events() + self.get_ambiences()
        return [ev.filepath for ev in events_ambs if ev.filepath is not None]

    def _get_used_class_ids(self) -> list[int]:
        """Class IDs used by all current Event objects."""
        return list(set(i.class_id for i in self.get_events()))

    def _get_random_audio(self, audio_paths: Optional[list[Path]] = None) -> Path:
        """A random audio file honouring duplicate/class uniqueness policies."""
        if audio_paths is None:
            audio_paths = self.fg_audios
        audio_paths = utils.sanitise_filepaths(audio_paths)

        if not self.allow_duplicate_audios:
            seen = self._get_used_audios()
            audio_paths = [i for i in audio_paths if i not in seen]
        if not self.allow_same_class_events:
            used_ids = self._get_used_class_ids()
            audio_paths = [
                ap
                for ap in audio_paths
                if self.class_mapping.infer_label_idx_from_filepath(ap)[0] not in used_ids
            ]
        if len(audio_paths) == 0:
            raise FileNotFoundError(
                "No audio files found to sample from! Make sure you pass a value to `fg_path` "
                "in Scene.__init__. You can also try setting `allow_duplicate_audios=True`, "
                "or setting `allow_same_class_events=True`."
            )
        return random.choice(audio_paths)

    def _coerce_polar_position(self, position=None, mic: Optional[str] = None) -> np.ndarray:
        """Convert (az, el, r) relative to a microphone into absolute XYZ."""
        if mic is None:
            if len(self.state.microphones) == 1:
                mic = list(self.state.microphones.keys())[0]
            elif len(self.state.microphones) == 0:
                raise ValueError(
                    "Cannot set `polar=True` when adding an Event when no microphone has been "
                    "added to the Scene"
                )
            else:
                raise ValueError(
                    "Must pass a microphone alias when `polar` is True and more than one "
                    "microphone has been added to the Scene"
                )
        if position is None:
            raise ValueError("Must pass a position when `polar` is True")
        return (
            self.state.get_microphone(mic).coordinates_center + utils.polar_to_cartesian(position)
        )[0]

    def _validate_user_defined_audio_filepath(self, user_filepath: Path, user_class_id) -> None:
        """Enforce the duplicate-audio and same-class policies for user files."""
        if not self.allow_duplicate_audios:
            if user_filepath in self._get_used_audios():
                raise ValueError(
                    f"Audio file {user_filepath.resolve()} has already been added to the Scene. "
                    f"Either increase the number of `fg_paths` in Scene.__init__, choose a "
                    f"different audio file, or set `Scene.allow_duplicate_audios=True`."
                )
        if not self.allow_same_class_events:
            seen_classes = self._get_used_class_ids()
            resolved_id = (
                self.class_mapping.infer_label_idx_from_filepath(user_filepath)[0]
                if user_class_id is None
                else user_class_id
            )
            if resolved_id in seen_classes:
                raise ValueError(
                    f"Audio file {user_filepath.resolve()} uses a class that has already been "
                    f"added to the Scene ({resolved_id}). Either choose a different audio file, "
                    f"or set `Scene.allow_same_class_events=True`."
                )

    # ------------------------------------------------------------------
    # Event placement
    # ------------------------------------------------------------------

    def _try_add_event(self, **event_kwargs) -> bool:
        """Rejection-sampling placement loop for static/moving events.

        Each attempt resamples distribution-driven parameters (scene start,
        duration, SNR, velocity, resolution), checks temporal overlap + scene
        bounds, then asks the WorldState to place the emitter(s)/trajectory.
        """
        if event_kwargs["image_filepath"] is not None:
            raise NotImplementedError("event images are not ported (ROADMAP: imaging and video)")

        alias = event_kwargs["alias"]
        # Note: even with full timing overrides we keep the retry budget — a single
        # attempt at a random *spatial* placement (emitter position / trajectory)
        # routinely fails, so the loop must be able to resample positions.
        max_place_attempts = event_kwargs.get("max_place_attempts", config.MAX_PLACE_ATTEMPTS)

        overrides = {
            "filepath": event_kwargs.get("filepath"),
            "image_filepath": event_kwargs.get("image_filepath"),
            "scene_start": event_kwargs.get("scene_start"),
            "event_start": event_kwargs.get("event_start"),
            "duration": event_kwargs.get("duration"),
            "snr": event_kwargs.get("snr"),
            "spatial_velocity": event_kwargs.get("spatial_velocity"),
            "spatial_resolution": event_kwargs.get("spatial_resolution"),
        }

        for _ in range(int(max_place_attempts)):
            current_kws = event_kwargs.copy()

            if overrides["filepath"] is None:
                current_kws["filepath"] = self._get_random_audio(self.fg_audios)

            if overrides["duration"] is None and self.event_duration_dist is None:
                current_kws["duration"] = None
            else:
                current_kws["duration"] = utils.sample_distribution(
                    self.event_duration_dist, overrides["duration"]
                )

            if overrides["event_start"] is None and self.event_start_dist is None:
                current_kws["event_start"] = None
            else:
                current_kws["event_start"] = utils.sample_distribution(
                    self.event_start_dist, overrides["event_start"]
                )

            current_kws.update(
                {
                    "scene_start": utils.sample_distribution(
                        self.scene_start_dist, overrides["scene_start"]
                    ),
                    "snr": utils.sample_distribution(self.snr_dist, overrides["snr"]),
                    "spatial_velocity": utils.sample_distribution(
                        self.event_velocity_dist, overrides["spatial_velocity"]
                    ),
                    "spatial_resolution": utils.sample_distribution(
                        self.event_resolution_dist, overrides["spatial_resolution"]
                    ),
                }
            )

            current_kws["class_id"], current_kws["class_label"] = infer_id_and_label_from_inputs(
                current_kws["class_id"],
                current_kws["class_label"],
                self.class_mapping,
                current_kws["filepath"],
            )

            valid_event_kwargs = utils.get_valid_kwargs(Event.__init__)
            current_event = Event(
                **{k: v for k, v in current_kws.items() if k in valid_event_kwargs}
            )

            if self._would_exceed_temporal_overlap(
                current_event.scene_start, current_event.scene_end
            ):
                continue
            if current_event.scene_end > self.duration:
                continue

            if event_kwargs.get("shape") == "static":
                # One attempt per parameter sample: a placement ValueError moves
                # to the next rejection-sampling iteration.
                emitter_kwargs = dict(
                    position=event_kwargs["position"],
                    alias=alias,
                    mic=event_kwargs["mic"],
                    ensure_direct_path=event_kwargs["ensure_direct_path"],
                    keep_existing=True,
                    max_place_attempts=1,
                )
                utils.validate_kwargs(self.state.add_emitter, **emitter_kwargs)
                try:
                    self.state.add_emitter(**emitter_kwargs)
                except ValueError:
                    continue
            else:
                emitter_kwargs = dict(
                    duration=current_event.duration,
                    velocity=current_event.spatial_velocity,
                    resolution=current_event.spatial_resolution,
                    shape=current_event.shape,
                    starting_position=event_kwargs["starting_position"],
                    ensure_direct_path=event_kwargs["ensure_direct_path"],
                    max_place_attempts=1,
                )
                utils.validate_kwargs(self.state.define_trajectory, **emitter_kwargs)
                try:
                    trajectory = self.state.define_trajectory(**emitter_kwargs)
                except ValueError:
                    continue
                self.state._add_emitters_without_validating(trajectory, alias)

            emitters = self.state.get_emitters(alias)
            current_event.register_emitters(emitters)
            self.events[alias] = current_event
            return True

        return False

    def add_event(
        self,
        event_type: Optional[str] = "static",
        filepath: Optional[Union[str, Path]] = None,
        alias: Optional[str] = None,
        augmentations=None,
        position=None,
        trajectory: Optional[np.ndarray] = None,
        mic: Optional[str] = None,
        polar: Optional[bool] = False,
        ensure_direct_path: Optional[Union[bool, list, str]] = False,
        scene_start: Optional[utils.Numeric] = None,
        event_start: Optional[utils.Numeric] = None,
        duration: Optional[utils.Numeric] = None,
        snr: Optional[utils.Numeric] = None,
        class_id: Optional[int] = None,
        class_label: Optional[str] = None,
        shape: Optional[str] = None,
        spatial_resolution: Optional[utils.Numeric] = None,
        spatial_velocity: Optional[utils.Numeric] = None,
        max_place_attempts: Optional[utils.Numeric] = config.MAX_PLACE_ATTEMPTS,
        image_filepath: Optional[Union[str, Path]] = None,
        **event_kwargs,
    ) -> Event:
        """Add an Event: "static", "moving", or "predefined" trajectory.

        Un-overridden parameters sample from the Scene's distributions; numeric
        values act as overrides.
        """
        if event_type == "static":
            event = self.add_event_static(
                filepath=filepath,
                alias=alias,
                position=position,
                mic=mic,
                polar=polar,
                ensure_direct_path=ensure_direct_path,
                scene_start=scene_start,
                event_start=event_start,
                duration=duration,
                snr=snr,
                class_id=class_id,
                class_label=class_label,
                augmentations=augmentations,
                max_place_attempts=max_place_attempts,
                image_filepath=image_filepath,
                **event_kwargs,
            )
        elif event_type == "moving":
            event = self.add_event_moving(
                filepath=filepath,
                alias=alias,
                position=position,
                polar=polar,
                mic=mic,
                shape=shape,
                scene_start=scene_start,
                event_start=event_start,
                duration=duration,
                snr=snr,
                class_id=class_id,
                class_label=class_label,
                spatial_resolution=spatial_resolution,
                spatial_velocity=spatial_velocity,
                augmentations=augmentations,
                ensure_direct_path=ensure_direct_path,
                max_place_attempts=max_place_attempts,
                image_filepath=image_filepath,
                **event_kwargs,
            )
        elif event_type == "predefined":
            raise NotImplementedError("predefined-trajectory events are not ported (ROADMAP)")
        else:
            raise ValueError(
                f"Cannot parse event type {event_type}, expected either 'static', 'moving', "
                f"or 'predefined'!"
            )

        logger.info(f"Event added successfully: {event}")
        return event

    def add_event_static(
        self,
        filepath: Optional[Union[str, Path]] = None,
        alias: Optional[str] = None,
        augmentations=None,
        position=None,
        mic: Optional[str] = None,
        polar: Optional[bool] = False,
        ensure_direct_path: Optional[Union[bool, list, str]] = False,
        scene_start: Optional[utils.Numeric] = None,
        event_start: Optional[utils.Numeric] = None,
        duration: Optional[utils.Numeric] = None,
        snr: Optional[utils.Numeric] = None,
        class_id: Optional[int] = None,
        class_label: Optional[str] = None,
        max_place_attempts: Optional[utils.Numeric] = config.MAX_PLACE_ATTEMPTS,
        image_filepath: Optional[Union[str, Path]] = None,
        **event_kwargs,
    ) -> Event:
        """Add a static (single-emitter) event with optional overrides."""
        alias = utils.get_default_alias("event", self.events) if alias is None else alias

        if filepath is not None:
            filepath = utils.sanitise_filepath(filepath)
            self._validate_user_defined_audio_filepath(filepath, class_id)

        if polar:
            position = self._coerce_polar_position(position, mic)
            mic = None  # offset already applied

        if augmentations:
            raise NotImplementedError("event augmentations are not ported (ROADMAP: augmentations)")

        event_kwargs_full = dict(
            filepath=filepath,
            alias=alias,
            scene_start=scene_start,
            event_start=event_start,
            duration=duration,
            snr=snr,
            sample_rate=self.sample_rate,
            class_id=class_id,
            class_label=class_label,
            spatial_resolution=None,
            spatial_velocity=None,
            shape="static",
            augmentations=augmentations,
            position=position,
            mic=mic,
            ensure_direct_path=ensure_direct_path,
            keep_existing=True,
            max_place_attempts=max_place_attempts,
            class_mapping=self.class_mapping,
            image_filepath=image_filepath,
            **event_kwargs,
        )

        placed = self._try_add_event(**event_kwargs_full)
        if not placed:
            raise ValueError(
                f"Could not place event in the mesh after {config.MAX_PLACE_ATTEMPTS} attempts. "
                f"Consider increasing the value of `max_overlap` (currently {self.max_overlap}) "
                f"or the `duration` of the scene (currently {self.duration})."
            )
        return self.get_event(alias)

    def add_event_moving(
        self,
        filepath: Optional[Union[str, Path]] = None,
        alias: Optional[str] = None,
        augmentations=None,
        position=None,
        mic: Optional[str] = None,
        polar: Optional[bool] = False,
        shape: Optional[str] = None,
        scene_start: Optional[utils.Numeric] = None,
        event_start: Optional[utils.Numeric] = None,
        duration: Optional[utils.Numeric] = None,
        snr: Optional[utils.Numeric] = None,
        class_id: Optional[int] = None,
        class_label: Optional[str] = None,
        spatial_resolution: Optional[utils.Numeric] = None,
        spatial_velocity: Optional[utils.Numeric] = None,
        ensure_direct_path: Optional[Union[bool, list, str]] = False,
        max_place_attempts: Optional[utils.Numeric] = config.MAX_PLACE_ATTEMPTS,
        image_filepath: Optional[Union[str, Path]] = None,
        **event_kwargs,
    ) -> Event:
        """Add a moving (multi-emitter trajectory) event with optional overrides."""
        if polar:
            position = self._coerce_polar_position(position, mic)

        alias = utils.get_default_alias("event", self.events) if alias is None else alias

        if filepath is not None:
            filepath = utils.sanitise_filepath(filepath)
            self._validate_user_defined_audio_filepath(filepath, class_id)

        if augmentations:
            raise NotImplementedError("event augmentations are not ported (ROADMAP: augmentations)")

        if shape is None:
            shape = random.choice(config.MOVING_EVENT_SHAPES)

        event_kwargs_full = dict(
            filepath=filepath,
            alias=alias,
            scene_start=scene_start,
            event_start=event_start,
            duration=duration,
            snr=snr,
            shape=shape,
            sample_rate=self.sample_rate,
            class_id=class_id,
            class_label=class_label,
            spatial_resolution=spatial_resolution,
            spatial_velocity=spatial_velocity,
            augmentations=augmentations,
            starting_position=position,
            ensure_direct_path=ensure_direct_path,
            max_place_attempts=max_place_attempts,
            class_mapping=self.class_mapping,
            image_filepath=image_filepath,
            **event_kwargs,
        )

        placed = self._try_add_event(**event_kwargs_full)
        if not placed:
            raise ValueError(
                f"Could not place event in the mesh after {config.MAX_PLACE_ATTEMPTS} attempts. "
                f"Consider increasing the value of `max_overlap` (currently {self.max_overlap}) "
                f"or the `duration` of the scene (currently {self.duration})."
            )
        return self.get_event(alias)

    def _would_exceed_temporal_overlap(self, new_event_start: float, new_event_end: float) -> bool:
        """True when adding [start, end] would exceed the overlap budget."""
        intersections = 0
        for event in self.events.values():
            if new_event_start < event.scene_end and new_event_end > event.scene_start:
                intersections += 1
        return intersections >= self.max_overlap

    # ------------------------------------------------------------------
    # Output generation
    # ------------------------------------------------------------------

    @staticmethod
    def _sanitise_output_directory(output_dir: Union[str, Path]) -> Path:
        """Validate the output directory (defaulting to the CWD)."""
        if output_dir is None:
            output_dir = Path.cwd()
        if not isinstance(output_dir, Path):
            output_dir = Path(output_dir)
        if not output_dir.is_dir():
            raise FileNotFoundError(f"Output directory {output_dir} does not exist")
        return output_dir

    def generate(
        self,
        output_dir: Optional[Union[str, Path]] = None,
        audio: bool = True,
        metadata_json: bool = True,
        metadata_dcase: bool = True,
        audio_fname: Optional[Union[str, Path]] = "audio_out",
        metadata_fname: Optional[Union[str, Path]] = "metadata_out",
        video: bool = False,
        video_fname: Optional[Union[str, Path]] = "video_out",
        compiled: bool = False,
    ) -> None:
        """Render the scene to disk: per-mic int16 WAVs, metadata JSON, DCASE CSVs.

        The audio renders on the world state's device through the fused
        renderer (pipeline.render_scenes: trace, stems, placement, ambience
        and int16 quantisation in one pass), or through the plan path where
        the fused renderer refuses the scene (the exact rain mode in a
        nonconvex room). `compiled=True` takes the plan path
        (pipeline.render_scene_audio_compiled: traced IR banks, device
        stems, host mix and host ambience bed). `video` and `video_fname` keep
        the reference's signature; video is not ported.
        """
        if video:
            raise NotImplementedError("video is not ported (ROADMAP item 1.8: video)")
        output_dir = self._sanitise_output_directory(output_dir)
        if audio and compiled:
            from audiblelight_tpu_torch.pipeline import render_scene_audio_compiled

            self.audio = render_scene_audio_compiled(self)
        elif audio:
            from audiblelight_tpu_torch.pipeline import render_scenes

            def complete(scene, payloads):
                scene.audio = payloads

            render_scenes([self], complete)
        write_outputs(self, (output_dir / audio_fname).with_suffix(""), (output_dir / metadata_fname).with_suffix(""),
                      audio=audio, metadata_json=metadata_json, metadata_dcase=metadata_dcase)

    # ------------------------------------------------------------------
    # Serialisation
    # ------------------------------------------------------------------

    def to_dict(self) -> dict:
        """Metadata for this Scene as a dictionary (JSON-serialisable), with the
        reference's keys and values, so either package loads the other's JSON."""
        return dict(
            audiblelight_version=__version__,
            rlr_audio_propagation_version="audiblelight_tpu-jax",
            creation_time=datetime.now().strftime("%Y-%m-%d_%H:%M:%S"),
            duration=self.duration,
            backend=self.state.name,
            sample_rate=self.sample_rate,
            ref_db=self.ref_db,
            max_overlap=self.max_overlap,
            fg_path=[str(fg.resolve()) for fg in self.fg_paths],
            bg_path=[str(fg.resolve()) for fg in self.bg_paths],
            ambience={k: a.to_dict() for k, a in self.ambience.items()},
            events={k: e.to_dict() for k, e in self.events.items()},
            state=self.state.to_dict(),
            class_mapping=(
                self.class_mapping.to_dict() if self.class_mapping is not None else None
            ),
        )

    @classmethod
    def from_dict(cls, input_dict: dict[str, Any], device=None) -> "Scene":
        """Instantiate a Scene (state, events, ambience) from a dictionary,
        with its world state on `device`. Distributions are not serialised
        and must be set again by hand."""
        for expected in [
            "audiblelight_version",
            "duration",
            "ref_db",
            "ambience",
            "events",
            "state",
            "sample_rate",
            "backend",
            "class_mapping",
        ]:
            if expected not in input_dict:
                raise KeyError(f"Missing key: '{expected}'")

        loaded_version = input_dict["audiblelight_version"]
        if loaded_version != __version__:
            logger.error(
                f"This Scene appears to have been created using a different version "
                f"(v.{loaded_version} vs installed v.{__version__}). Loading will be attempted."
            )

        logger.warning(
            "Currently, distributions cannot be loaded with `Scene.from_dict`. You will need to "
            "manually redefine these using, for instance, setattr(scene, 'event_start_dist', ...)."
        )

        if "backend" not in input_dict["state"]:
            raise KeyError("Must set 'backend' key to parse from dictionary")
        state = get_worldstate_from_string(input_dict["state"]["backend"]).from_dict(
            input_dict["state"], device=device
        )
        class_mapping = ClassMapping.from_dict(input_dict["class_mapping"])

        scene = cls(
            duration=input_dict["duration"],
            backend=state,
            sample_rate=input_dict["sample_rate"],
            fg_path=input_dict.get("fg_path") or None,
            bg_path=input_dict.get("bg_path") or None,
            ref_db=input_dict["ref_db"],
            max_overlap=input_dict["max_overlap"],
            class_mapping=class_mapping,
        )
        scene.events = OrderedDict(
            {k: Event.from_dict(v) for k, v in input_dict["events"].items()}
        )
        scene.ambience = OrderedDict(
            {k: Ambience.from_dict(v) for k, v in input_dict["ambience"].items()}
        )
        return scene

    @classmethod
    def from_json(cls, json_fpath: Union[str, Path], device=None) -> "Scene":
        """Instantiate a Scene from a JSON file produced by `generate`."""
        sanitised = utils.sanitise_filepath(json_fpath)
        with open(sanitised) as f:
            loaded = json.load(f)
        return cls.from_dict(loaded, device=device)

    # ------------------------------------------------------------------
    # Getters / clearers
    # ------------------------------------------------------------------

    def get_events(self) -> list[Event]:
        """All Events in the scene."""
        return list(self.events.values())

    def get_event(self, alias_or_idx: Union[str, int]) -> Event:
        """An Event by alias (str) or index (int)."""
        if isinstance(alias_or_idx, str):
            if alias_or_idx in self.events:
                return self.events[alias_or_idx]
            raise KeyError(f"Event alias '{alias_or_idx}' not found.")
        if isinstance(alias_or_idx, int):
            try:
                return list(self.events.values())[alias_or_idx]
            except IndexError:
                raise IndexError(f"No event with index {alias_or_idx}.")
        raise TypeError(f"Expected `str` or `int` but got {type(alias_or_idx)}")

    def get_emitters(self, alias: str) -> list[Emitter]:
        """Alias for `WorldState.get_emitters`."""
        return self.state.get_emitters(alias)

    def get_emitter(self, alias: str, emitter_idx: int = 0) -> Emitter:
        """Alias for `WorldState.get_emitter`."""
        return self.state.get_emitter(alias, emitter_idx)

    def get_microphone(self, alias: str) -> MicArray:
        """Alias for `WorldState.get_microphone`."""
        return self.state.get_microphone(alias)

    def get_microphones(self) -> list[MicArray]:
        """Alias for `WorldState.get_microphones`."""
        return self.state.get_microphones()

    def get_ambience(self, alias) -> Ambience:
        """An Ambience object by alias."""
        if alias in self.ambience:
            return self.ambience[alias]
        raise KeyError(f"Ambience alias '{alias}' not found.")

    def get_ambiences(self) -> list[Ambience]:
        """All Ambience objects."""
        return list(self.ambience.values())

    def get_class_mapping(self):
        """The class-mapping dictionary (or None)."""
        return self.class_mapping.to_dict() if self.class_mapping is not None else None

    def clear_events(self) -> None:
        """Remove all events and their emitters."""
        self.events = OrderedDict()
        self.state.clear_emitters()

    def clear_event(self, alias: str) -> None:
        """Remove one event and its emitters from the state."""
        if alias in self.events:
            ev = self.events[alias]
            for emitter in ev.get_emitters():
                self.state.clear_emitter(emitter.alias)
            del self.events[alias]
        else:
            raise KeyError(f"Event alias '{alias}' not found.")

    def clear_emitters(self) -> None:
        """Alias for `WorldState.clear_emitters` (may orphan events)."""
        if len(self.events) > 0:
            logger.warning(
                "Clearing emitters from a scene may orphan its associated events. "
                "Prefer `Scene.clear_events()`."
            )
        self.state.clear_emitters()

    def clear_microphones(self) -> None:
        """Alias for `WorldState.clear_microphones`."""
        self.state.clear_microphones()

    def clear_emitter(self, alias: str) -> None:
        """Alias for `WorldState.clear_emitter` (may orphan an event)."""
        if len(self.events) > 0 and alias in self.events:
            logger.warning(
                f"Clearing emitters with the alias '{alias}' will orphan an event. "
                f"Prefer `Scene.clear_event(alias)`."
            )
        self.state.clear_emitter(alias)

    def clear_microphone(self, alias: str) -> None:
        """Alias for `WorldState.clear_microphone`."""
        self.state.clear_microphone(alias)

    def clear_ambience(self) -> None:
        """Remove all ambience objects."""
        self.ambience = OrderedDict()


def write_outputs(scene: Scene, audio_path: Path, metadata_path: Path, audio: bool = True,
                  metadata_json: bool = True, metadata_dcase: bool = True) -> None:
    """Write a rendered scene's files: an int16 WAV per mic at
    `<audio_path>_<mic>.wav`, the metadata JSON at `<metadata_path>.json` and
    a DCASE CSV per mic at `<metadata_path>_<mic>.csv` (the reference's
    names, from `Scene.generate` and the SELD script alike)."""
    from audiblelight_tpu_torch.synthesize import dcase_csv_text, generate_dcase2024_metadata

    if audio:
        for mic_alias, mic_audio in scene.audio.items():
            wav_write(audio_path.parent / f"{audio_path.name}_{mic_alias}.wav", mic_audio,
                      int(scene.sample_rate), subtype="int16")
    if metadata_json:
        with open(metadata_path.with_suffix(".json"), "w") as f:
            json.dump(scene.to_dict(), f, indent=4, ensure_ascii=False)
    if metadata_dcase:
        for mic, rows in generate_dcase2024_metadata(scene).items():
            (metadata_path.parent / f"{metadata_path.name}_{mic}.csv").write_text(dcase_csv_text(rows),
                                                                                  encoding="utf-8")
