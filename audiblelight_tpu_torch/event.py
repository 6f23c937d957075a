"""Event: a single (static or moving) sound event placed inside a Scene.

Copy of audiblelight_tpu/event.py: timing fields (scene_start / event_start
/ duration), emitter registration (moving when more than one emitter),
augmentation registration with audio-cache invalidation, audio loading (WAV
slice, resample, mono, augment, peak-normalise), the event image (PIL), the
dry-source parameters, and the dict round trip. `device` is where the augmentations' torch FX run
(an Event that a Scene made: the scene's device; default `cuda`).
"""

from __future__ import annotations

from collections import OrderedDict
from pathlib import Path
from typing import Any, Iterable, Optional, Union

import numpy as np

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.augmentation import EventAugmentation, validate_event_augmentation
from audiblelight_tpu_torch.class_mappings import (
    TClassMapping,
    infer_id_and_label_from_inputs,
    sanitize_class_mapping,
)
from audiblelight_tpu_torch.io.audio import get_duration, load_audio, valid_audio
from audiblelight_tpu_torch.micarrays import _compare_dicts
from audiblelight_tpu_torch.utils import logger
from audiblelight_tpu_torch.worldstate.base import Emitter


class Event:
    """Represents a single audio event taking place inside a Scene."""

    def __init__(
        self,
        filepath: Union[str, Path],
        alias: str,
        emitters: Optional[Union[list[Emitter], Emitter, list[dict]]] = None,
        augmentations: Optional[Iterable] = None,
        image_filepath: Optional[Union[str, Path]] = None,
        scene_start: Optional[float] = None,
        event_start: Optional[float] = None,
        duration: Optional[float] = None,
        snr: Optional[float] = None,
        sample_rate: Optional[int] = config.SAMPLE_RATE,
        class_id: Optional[int] = None,
        class_label: Optional[str] = None,
        spatial_resolution: Optional[Union[int, float]] = None,
        spatial_velocity: Optional[Union[int, float]] = None,
        shape: Optional[str] = None,
        class_mapping: Optional[Union[TClassMapping, dict, str]] = None,
        ref_ir_channel: Optional[int] = None,
        direct_path_time_ms: Optional[Iterable] = None,
        device=None,
    ):
        """Initialise the Event.

        `scene_start` is when the event begins within the Scene; `event_start`
        the offset into the source audio file; `duration` caps the audio
        length; `ref_ir_channel` + `direct_path_time_ms` (both together)
        describe the dry source; `augmentations` are EventAugmentation
        instances or classes, applied in order when the audio loads; `device`
        is where their torch FX run (set on each augmentation when given).
        """
        self.filepath = utils.sanitise_filepath(filepath)
        self.audio = None
        self.snr = snr
        self.sample_rate = utils.sanitise_positive_number(sample_rate)
        self.alias = alias
        self.device = device

        self.augmentations = []
        if augmentations is not None:
            self.register_augmentations(augmentations)

        # {mic_alias: spatialised audio} — populated by the synthesizer. The
        # spatial audio here is trimmed to the event duration.
        self.spatial_audio = OrderedDict()

        self.spatial_resolution = spatial_resolution
        self.spatial_velocity = spatial_velocity

        self.image_filepath = (
            utils.sanitise_filepath(image_filepath) if image_filepath is not None else None
        )
        self.image = None

        self.filename = self.filepath.name
        self.class_mapping = sanitize_class_mapping(class_mapping)
        self.class_id, self.class_label = infer_id_and_label_from_inputs(
            class_id, class_label, self.class_mapping, self.filepath
        )

        self.audio_full_duration = utils.sanitise_positive_number(get_duration(self.filepath))
        self.event_start = self._parse_audio_start(event_start)
        self.scene_start = (
            utils.sanitise_positive_number(scene_start) if scene_start is not None else 0.0
        )
        self.duration = self._parse_duration(duration)
        self.event_end = self.event_start + self.duration
        self.scene_end = self.scene_start + self.duration

        self.emitters = None
        self.is_moving = None

        self.start_coordinates_absolute = None
        self.end_coordinates_absolute = None
        self.start_coordinates_relative_cartesian = None
        self.end_coordinates_relative_cartesian = None
        self.start_coordinates_relative_polar = None
        self.end_coordinates_relative_polar = None

        self.shape = shape

        if emitters is not None:
            self.register_emitters(emitters)

        # Untrimmed spatial audio padded to the scene duration
        self._spatial_audio_padded = OrderedDict()
        # "Dry" audio (direct path + early reflections at ref channel)
        self._spatial_audio_dry = OrderedDict()
        self._spatial_audio_dry_padded = OrderedDict()
        self.ref_ir_channel = (
            utils.sanitise_positive_number(ref_ir_channel, cast_to=int)
            if ref_ir_channel is not None
            else None
        )
        self.direct_path_time_ms = (
            self._parse_direct_path_time_ms(direct_path_time_ms)
            if direct_path_time_ms is not None
            else None
        )

    @staticmethod
    def _parse_direct_path_time_ms(direct_path_time_ms: Optional[Iterable]) -> list[int]:
        """Validate (lower, upper) bounds in ms for the dry-source direct path."""
        try:
            if len(direct_path_time_ms) != 2:
                raise ValueError(
                    f"Expected two values for `direct_path_time_ms` (upper and lower bound),"
                    f" but got {len(direct_path_time_ms)} values."
                )
        except TypeError:
            raise TypeError(
                f"Expected `direct_path_time_ms` to be an iterable of two values, "
                f"but got type {type(direct_path_time_ms)}."
            )
        return [utils.sanitise_positive_number(i, cast_to=int) for i in direct_path_time_ms]

    def register_augmentations(self, augmentations) -> None:
        """Register augmentations (instances, or classes made at the Event's
        sample rate), validating their sample rate, and invalidate the cached
        audio. With a `device`, each runs its FX there."""
        if not isinstance(augmentations, (list, tuple, set)):
            augmentations = [augmentations]

        for aug in augmentations:
            if isinstance(aug, type):
                aug = aug(sample_rate=self.sample_rate)
            if aug.sample_rate != self.sample_rate:
                raise ValueError(
                    f"Augmentation has mismatching sample rate! "
                    f"expected {self.sample_rate}, got {aug.sample_rate}"
                )
            validate_event_augmentation(aug)
            if self.device is not None:
                aug.device = self.device
            self.augmentations.append(aug)

        self._clear_audio()

    def register_emitters(self, emitters: Union[list[Emitter], Emitter, list[dict]]) -> None:
        """Register emitters; multiple emitters means the event is moving."""
        self.emitters = self._parse_emitters(emitters)
        self.is_moving = len(self.emitters) > 1

        first = self.emitters[0]
        self.start_coordinates_absolute = first.coordinates_absolute
        self.start_coordinates_relative_cartesian = first.coordinates_relative_cartesian
        self.start_coordinates_relative_polar = first.coordinates_relative_polar

        if self.is_moving:
            last = self.emitters[-1]
            self.end_coordinates_absolute = last.coordinates_absolute
            self.end_coordinates_relative_cartesian = last.coordinates_relative_cartesian
            self.end_coordinates_relative_polar = last.coordinates_relative_polar
        else:
            self.end_coordinates_absolute = self.start_coordinates_absolute
            self.end_coordinates_relative_cartesian = self.start_coordinates_relative_cartesian
            self.end_coordinates_relative_polar = self.start_coordinates_relative_polar

    def __str__(self) -> str:
        loaded = "loaded" if self.is_audio_loaded else "unloaded"
        moving = "Moving" if self.is_moving else "Static"
        emits = "no " if self.emitters is None else len(self)
        return (
            f"{moving} 'Event' with alias '{self.alias}',"
            f" audio file '{self.filepath}' ({loaded}, {len(self.augmentations)} augmentations), "
            f"{emits} emitter(s)."
        )

    def __repr__(self) -> str:
        return utils.repr_as_json(self)

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Event):
            return False
        return _compare_dicts(self.to_dict(), other.to_dict(), exclude=("emitters",))

    def __len__(self) -> int:
        if self.has_emitters:
            return len(self.emitters)
        raise ValueError("Cannot get length of an Event object without registered emitters.")

    @property
    def has_emitters(self) -> bool:
        """True when valid emitters are associated with this Event."""
        return self.emitters is not None and all(isinstance(e, Emitter) for e in self.emitters)

    @property
    def is_audio_loaded(self) -> bool:
        """True when audio is loaded and valid."""
        if self.audio is None:
            return False
        try:
            return valid_audio(self.audio)
        except (TypeError, ValueError):
            return False

    @property
    def is_image_loaded(self) -> bool:
        """True when an image is loaded and valid."""
        return self.image is not None and isinstance(self.image, np.ndarray) and self.image.ndim == 3

    def _parse_emitters(self, emitters) -> list[Emitter]:
        """Coerce Emitter / dict / list / coordinate inputs to list[Emitter]."""
        if isinstance(emitters, Emitter):
            return [emitters]
        if isinstance(emitters, dict):
            return [Emitter.from_dict(emitters)]
        if isinstance(emitters, list):
            if len(emitters) < 1:
                raise ValueError("At least one emitter must be provided")
            if all(isinstance(em, dict) for em in emitters):
                return [Emitter.from_dict(d) for d in emitters]
            if all(isinstance(em, Emitter) for em in emitters):
                return emitters
            if all(isinstance(em, (np.ndarray, list)) for em in emitters):
                return [
                    Emitter(alias=self.alias, coordinates_absolute=utils.sanitise_coordinates(em))
                    for em in emitters
                ]
            raise TypeError(f"Cannot parse emitter with type {type(emitters[0])}")
        raise TypeError(f"Cannot parse emitters with type {type(emitters)}")

    def _parse_audio_start(self, audio_start: Optional[utils.Numeric] = None) -> float:
        """Audio offset with fallback-to-zero when beyond the file duration."""
        if audio_start is None:
            event_start_ = 0.0
        elif audio_start > self.audio_full_duration:
            logger.warning(
                f"Event start time ({audio_start:.2f} seconds) exceeds duration of the audio "
                f"file ({self.audio_full_duration:.2f} seconds). Start time will be set to 0."
            )
            event_start_ = 0.0
        else:
            event_start_ = audio_start
        return utils.sanitise_positive_number(event_start_)

    def _parse_duration(self, duration: Optional[float] = None) -> float:
        """Duration override, capped by the available audio after the offset."""
        if duration is None:
            return utils.sanitise_positive_number(self.audio_full_duration - self.event_start)
        duration = utils.sanitise_positive_number(duration)
        if self.event_start + duration > self.audio_full_duration:
            return self.audio_full_duration - self.event_start
        return duration

    def load_audio(
        self, ignore_cache: Optional[bool] = False, normalize: Optional[bool] = True
    ) -> np.ndarray:
        """Load (and cache) the event audio: slice, resample, augment, normalise."""
        if (
            self.is_audio_loaded
            and not ignore_cache
            and getattr(self, "_audio_normalized", None) == bool(normalize)
        ):
            # The cache is only valid for the SAME normalize flag: a raw
            # (normalize=False) inspection must not poison the render path's
            # normalized load, whose dry-stem levels scale with the peak.
            return self.audio

        audio_raw, _ = load_audio(
            self.filepath,
            sr=self.sample_rate,
            mono=True,
            offset=self.event_start,
            duration=self.duration,
            dtype=np.float32,
        )

        audio_out = audio_raw.copy()
        for aug in self.augmentations:
            audio_out = aug(audio_out)

        if normalize:
            audio_out = audio_out / np.max(np.abs(audio_out) + utils.tiny(audio_out))

        self.audio = audio_out
        self._audio_normalized = bool(normalize)
        return self.audio

    def load_image(self, ignore_cache: Optional[bool] = False) -> np.ndarray:
        """Load (and cache) the event image as an RGB uint8 array, through PIL
        (an ImportError where PIL is absent, as the reference raises)."""
        if self.is_image_loaded and not ignore_cache:
            return self.image
        if self.image_filepath is None:
            raise FileNotFoundError("No image filepath was passed when calling `Event.__init__`")
        from PIL import Image

        image_loaded = Image.open(self.image_filepath).convert("RGB")
        self.image = np.asarray(image_loaded, dtype=np.uint8)
        return self.image

    def to_dict(self) -> dict:
        """Metadata for this Event as a dictionary."""
        if not self.has_emitters:
            raise ValueError("Cannot dump metadata for an Event with no Emitters!")

        relative_positions = {}
        for emitter in self.emitters:
            for k, v in emitter.coordinates_relative_polar.items():
                entry = utils.coerce_nested_inputs(np.atleast_2d(v))[0]
                relative_positions.setdefault(k, []).append(entry)

        return dict(
            alias=self.alias,
            filename=str(self.filename),
            filepath=str(self.filepath),
            class_id=self.class_id,
            class_label=self.class_label,
            is_moving=self.is_moving,
            scene_start=self.scene_start,
            scene_end=self.scene_end,
            event_start=self.event_start,
            event_end=self.event_end,
            duration=self.duration,
            snr=self.snr,
            sample_rate=self.sample_rate,
            image_filepath=(str(self.image_filepath) if self.image_filepath is not None else None),
            spatial_resolution=self.spatial_resolution if self.is_moving else None,
            spatial_velocity=self.spatial_velocity if self.is_moving else None,
            shape=self.shape,
            num_emitters=len(self.emitters),
            emitters=[
                utils.coerce_nested_inputs(v.coordinates_absolute) for v in self.emitters
            ],
            emitters_relative=relative_positions,
            augmentations=[aug.to_dict() for aug in self.augmentations],
            ref_ir_channel=self.ref_ir_channel,
            direct_path_time_ms=self.direct_path_time_ms,
        )

    @classmethod
    def from_dict(cls, input_dict: dict[str, Any], device=None) -> "Event":
        """Instantiate an Event from a dictionary, its augmentations' FX on `device`."""
        for k in [
            "alias",
            "filepath",
            "emitters",
            "snr",
            "duration",
            "event_start",
            "scene_start",
            "scene_end",
        ]:
            if k not in input_dict:
                raise KeyError(f"Missing key: '{k}'")

        emitters_list = []
        emitters_relative = input_dict.get("emitters_relative", {})
        for emitter_idx, emitter in enumerate(input_dict["emitters"]):
            obj = Emitter(alias=input_dict["alias"], coordinates_absolute=np.asarray(emitter))
            obj.coordinates_relative_polar = OrderedDict(
                {k: np.array([emitters_relative[k][emitter_idx]]) for k in emitters_relative}
            )
            obj.coordinates_relative_cartesian = OrderedDict(
                {
                    k: utils.polar_to_cartesian(emitters_relative[k][emitter_idx])
                    for k in emitters_relative
                }
            )
            emitters_list.append(obj)

        augs = [EventAugmentation.from_dict(aug, device=device) for aug in input_dict.get("augmentations", [])]

        return cls(
            alias=input_dict["alias"],
            filepath=input_dict["filepath"],
            emitters=emitters_list,
            augmentations=augs,
            scene_start=input_dict["scene_start"],
            event_start=input_dict["event_start"],
            duration=input_dict["duration"],
            snr=input_dict["snr"],
            image_filepath=input_dict.get("image_filepath", None),
            shape=input_dict.get("shape", None),
            sample_rate=input_dict["sample_rate"],
            class_id=input_dict["class_id"],
            class_label=input_dict["class_label"],
            spatial_resolution=input_dict["spatial_resolution"],
            spatial_velocity=input_dict["spatial_velocity"],
            ref_ir_channel=input_dict.get("ref_ir_channel", None),
            direct_path_time_ms=input_dict.get("direct_path_time_ms", None),
            device=device,
        )

    def get_augmentation(self, idx: int) -> EventAugmentation:
        """A single augmentation by integer index."""
        try:
            return self.augmentations[idx]
        except IndexError:
            raise IndexError(f"No augmentation with index {idx}")

    def get_augmentations(self) -> list[EventAugmentation]:
        """All augmentations associated with this Event."""
        return self.augmentations

    def get_emitter(self, idx: int) -> Emitter:
        """A single Emitter by integer index."""
        try:
            return self.emitters[idx]
        except (IndexError, TypeError):
            raise IndexError(f"No emitter with index {idx}")

    def get_emitters(self) -> list[Emitter]:
        """All emitters associated with this Event."""
        return self.emitters if self.emitters is not None else []

    def clear_augmentation(self, idx: int) -> None:
        """Remove an augmentation by index (invalidates cached audio)."""
        try:
            del self.augmentations[idx]
        except IndexError:
            raise IndexError(f"No augmentation found at index {idx}")
        self._clear_audio()

    def clear_augmentations(self) -> None:
        """Remove all augmentations (invalidates cached audio)."""
        if len(self.augmentations) > 0:
            self.augmentations = []
            self._clear_audio()

    def clear_emitters(self) -> None:
        """Remove all emitters (invalidates cached audio)."""
        self.emitters = None
        self._clear_audio()

    def clear_emitter(self, idx: int) -> None:
        """Remove an Emitter by index (invalidates cached audio)."""
        try:
            del self.emitters[idx]
        except (IndexError, TypeError):
            raise IndexError(f"No emitter with index {idx}")
        if len(self.emitters) == 0:
            self.emitters = None
        self._clear_audio()

    def _clear_audio(self) -> None:
        """Reset all cached audio buffers."""
        self.audio = None
        self.spatial_audio = OrderedDict()
        self._spatial_audio_dry_padded = OrderedDict()
        self._spatial_audio_dry = OrderedDict()
        self._spatial_audio_padded = OrderedDict()
