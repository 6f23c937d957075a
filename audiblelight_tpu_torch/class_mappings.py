"""Mappings converting sound-event class labels to indices for the DCASE tasks.

Copy of audiblelight_tpu/class_mappings.py. The label/index tables are
facts of the public DCASE challenge definitions (2020-2025).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional, Type, TypeVar, Union

from audiblelight_tpu_torch.utils import logger


class ClassMapping:
    """Parent class for all class mapping objects."""

    YEAR = None
    TASK = None

    def __init__(self, mapping: Optional[dict[str, int]] = None):
        self._mapping = mapping or {}
        self.validate_mapping()

    @property
    def mapping(self) -> dict[str, int]:
        """Mapping of class_name -> class_index."""
        return self._mapping

    @property
    def mapping_inverted(self) -> dict[int, str]:
        """Inverted mapping of class_index -> class_name."""
        return {v: k for k, v in self.mapping.items()}

    def infer_label_idx_from_filepath(
        self, filepath: Union[Path, str]
    ) -> Union[tuple[int, str], tuple[None, None]]:
        """Infer (class_index, class_label) from a filepath's directory parts.

        Returns (None, None) with a warning when no part of the path matches a class.
        Raises when multiple parts match distinct classes.
        """
        if not isinstance(filepath, Path):
            filepath = Path(filepath)

        cls, idx = None, None
        for part in filepath.parts:
            if part in self.mapping:
                if cls is None and idx is None:
                    cls = part
                    idx = self[cls]
                else:
                    raise ValueError(
                        f"Found multiple possible classes for filepath {filepath}: "
                        f"matches both {cls} and {part}. Adjust your filepaths so they "
                        f"contain only one class."
                    )

        if idx is None or cls is None:
            logger.warning(f"Could not find a matching class index and label for file {filepath}!")
        return idx, cls

    def infer_missing_values(
        self, class_id: Optional[int], class_label: Optional[str]
    ) -> tuple[Optional[int], Optional[str]]:
        """Infer a missing class ID or label when exactly one of the two is given."""
        if class_id is None and class_label is not None:
            class_id = self[class_label]
        elif class_id is not None and class_label is None:
            class_label = self[class_id]
        return class_id, class_label

    def __len__(self) -> int:
        return len(self.mapping)

    def __getitem__(self, item: Any) -> Any:
        """Convert a class name into class index, and vice-versa."""
        if item in self.mapping:
            return self.mapping[item]
        if item in self.mapping_inverted:
            return self.mapping_inverted[item]
        raise KeyError(f"Item {item} is not a valid key or value")

    @classmethod
    def from_dict(cls, input_dict: dict[str, int]):
        """Construct a class mapping from a dictionary."""
        return cls(mapping=input_dict)

    def to_dict(self) -> dict[str, int]:
        """Return the class mapping as a dictionary."""
        return self.mapping

    def validate_mapping(self) -> None:
        """Validate types, uniqueness and 0..N-1 contiguity of indices."""
        if not isinstance(self.mapping, dict):
            raise TypeError(f"Mapping must be a dict, but got {type(self.mapping)}.")
        for k, v in self.mapping.items():
            if not isinstance(k, str):
                raise TypeError(f"Class name must be str, got {type(k).__name__}: {k}")
            if not isinstance(v, int):
                raise TypeError(f"Class index must be int, got {type(v).__name__}: {v}")
        indices = list(self.mapping.values())
        if len(indices) != len(set(indices)):
            raise ValueError("Duplicate indices detected.")
        if indices and sorted(indices) != list(range(min(indices), max(indices) + 1)):
            raise ValueError("Indices must be contiguous from 0..N-1.")


class DCASE2023Task3(ClassMapping):
    """DCASE 2023 task 3 sound-event classes."""

    YEAR = 2023
    TASK = 3

    @property
    def mapping(self) -> dict[str, int]:
        return {
            "femaleSpeech": 0,
            "maleSpeech": 1,
            "clapping": 2,
            "telephone": 3,
            "laughter": 4,
            "domesticSounds": 5,
            "footsteps": 6,
            "doorCupboard": 7,
            "music": 8,
            "musicInstrument": 9,
            "waterTap": 10,
            "bell": 11,
            "knock": 12,
        }


class DCASE2021Task3(ClassMapping):
    """DCASE 2021 task 3 sound-event classes."""

    YEAR = 2021
    TASK = 3

    @property
    def mapping(self) -> dict[str, int]:
        return {
            "alarm": 0,
            "baby": 1,
            "crash": 2,
            "dog": 3,
            "femaleScream": 4,
            "femaleSpeech": 5,
            "footsteps": 6,
            "knock": 7,
            "maleScream": 8,
            "maleSpeech": 9,
            "phone": 10,
            "piano": 11,
        }


class DCASE2020Task3(ClassMapping):
    """DCASE 2020 task 3 sound-event classes."""

    YEAR = 2020
    TASK = 3

    @property
    def mapping(self) -> dict[str, int]:
        return {
            "alarm": 0,
            "baby": 1,
            "crash": 2,
            "dog": 3,
            "engine": 4,
            "femaleScream": 5,
            "femaleSpeech": 6,
            "fire": 7,
            "footsteps": 8,
            "knock": 9,
            "maleScream": 10,
            "maleSpeech": 11,
            "phone": 12,
            "piano": 13,
        }


class DCASE2025Task4(ClassMapping):
    """DCASE 2025 task 4 sound-event classes."""

    YEAR = 2025
    TASK = 4

    @property
    def mapping(self) -> dict[str, int]:
        return {
            "AlarmClock": 0,
            "BicycleBell": 1,
            "Blender": 2,
            "Buzzer": 3,
            "Clapping": 4,
            "Cough": 5,
            "CupboardOpenClose": 6,
            "Dishes": 7,
            "Doorbell": 8,
            "FootSteps": 9,
            "HairDryer": 10,
            "MechanicalFans": 11,
            "MusicalKeyboard": 12,
            "Percussion": 13,
            "Pour": 14,
            "Speech": 15,
            "Typing": 16,
            "VacuumCleaner": 17,
        }


ALL_MAPPINGS = [
    DCASE2023Task3,
    DCASE2021Task3,
    DCASE2020Task3,
    DCASE2025Task4,
]

TClassMapping = TypeVar("TClassMapping", bound="ClassMapping")


def get_class_mapping_from_string(class_mapping: str) -> Type[TClassMapping]:
    """Return the ClassMapping type matching a (case-insensitive) name string."""
    acceptable = [t.__name__ for t in ALL_MAPPINGS]
    if class_mapping.upper() not in [a.upper() for a in acceptable]:
        raise ValueError(
            f"Cannot find class mapping {class_mapping}: expected one of {', '.join(acceptable)}"
        )
    return next(m for m in ALL_MAPPINGS if m.__name__.upper() == class_mapping.upper())


def sanitize_class_mapping(
    class_mapping: Optional[Union[TClassMapping, dict, str]]
) -> Optional[ClassMapping]:
    """Coerce str / dict / class / instance inputs into an initialised ClassMapping."""
    if class_mapping is None:
        return None
    if isinstance(class_mapping, str):
        return get_class_mapping_from_string(class_mapping)()
    if isinstance(class_mapping, dict):
        return ClassMapping.from_dict(class_mapping)
    if isinstance(class_mapping, ClassMapping):
        return class_mapping
    if isinstance(class_mapping, type) and issubclass(class_mapping, ClassMapping):
        return class_mapping()
    raise TypeError(f"Could not parse class mapping with type {type(class_mapping)}")


def infer_id_and_label_from_inputs(
    class_id: Optional[int] = None,
    class_label: Optional[str] = None,
    class_mapping: ClassMapping = None,
    filepath: str = None,
) -> tuple[Union[int, None], Union[str, None]]:
    """Infer missing class IDs and labels from the available inputs.

    Three cases: both given -> trusted as-is; exactly one given -> other inferred from
    the mapping; neither given -> both inferred from the filepath when possible.
    """
    if class_id is not None and class_label is not None:
        return class_id, class_label
    if (class_id is None) != (class_label is None):
        if class_mapping is not None:
            return class_mapping.infer_missing_values(class_id, class_label)
    if class_id is None and class_label is None:
        if class_mapping is not None and filepath is not None:
            return class_mapping.infer_label_idx_from_filepath(filepath)
    return class_id, class_label
