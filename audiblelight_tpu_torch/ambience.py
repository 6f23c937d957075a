"""Background ambience of a Scene: colored noise.

Copy of audiblelight_tpu/ambience.py for noise beds ("gaussian", the colour
names, or a numeric power-law exponent). An Ambience only describes its bed:
the fused renderer draws it on the card (render.ambience_bed_device). The
host-side draw and file-based beds are not ported (ROADMAP).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional, Union

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.micarrays import _compare_dicts

# Map of colour names to beta exponents; higher beta = more low-frequency energy
NOISE_MAPPING = dict(pink=1, brown=2, red=2, blue=-1, white=0, violet=-2)
# Keywords of the reference's powerlaw_psd_gaussian that an Ambience records
NOISE_KWARGS = ("fmin", "seed")


class Ambience:
    """Persistent background noise for a Scene."""

    def __init__(
        self,
        channels: int,
        duration: utils.Numeric,
        alias: str,
        filepath: Optional[Union[str, Path]] = None,
        noise: Optional[Union[str, utils.Numeric]] = None,
        ref_db: Optional[utils.Numeric] = config.DEFAULT_REF_DB,
        sample_rate: Optional[utils.Numeric] = config.SAMPLE_RATE,
        **kwargs,
    ):
        """Initialise invariant background noise for a Scene.

        `noise` is a colour name, "gaussian", or a numeric beta exponent; extra
        kwargs (`fmin`, `seed`) are recorded as the reference records them.
        `filepath` raises.
        """
        self.channels = utils.sanitise_positive_number(channels, cast_to=int)
        self.sample_rate = utils.sanitise_positive_number(sample_rate, cast_to=int)
        self.duration = utils.sanitise_positive_number(duration)
        self.alias = alias

        if noise is None and filepath is not None:
            raise NotImplementedError("file-based ambience is not ported (ROADMAP); pass `noise`")
        elif noise is not None and filepath is None:
            self.filepath, self.beta = None, _parse_beta(noise)
        elif noise is not None and filepath is not None:
            raise AttributeError("Only one of `noise` or `filepath` should be provided.")
        else:
            raise AttributeError("One of `noise` or `filepath` must be provided")

        for kwarg in kwargs:
            if kwarg not in NOISE_KWARGS:
                raise AttributeError(f"`{kwarg}` is not a valid keyword argument for `powerlaw_psd_gaussian`")
        self.noise_kwargs = kwargs

        # The noise floor must be a negative dB value
        utils.sanitise_positive_number(-ref_db)
        self.ref_db = ref_db

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, Ambience):
            return False
        return _compare_dicts(self.to_dict(), other.to_dict())

    def __str__(self) -> str:
        return f"'Ambience' with alias '{self.alias}'."

    def __repr__(self) -> str:
        return utils.repr_as_json(self)

    def to_dict(self) -> dict:
        """Metadata for this object as a dictionary."""
        return dict(
            alias=self.alias,
            beta=self.beta,
            filepath=str(self.filepath) if self.filepath is not None else None,
            channels=self.channels,
            sample_rate=self.sample_rate,
            duration=self.duration,
            ref_db=self.ref_db,
            noise_kwargs=self.noise_kwargs,
        )

    @classmethod
    def from_dict(cls, input_dict: dict[str, Any]) -> "Ambience":
        """Instantiate Ambience from a dictionary."""
        for k in ["alias", "filepath", "duration", "ref_db", "beta", "channels"]:
            if k not in input_dict:
                raise KeyError(f"Missing key: '{k}'")
        return cls(
            channels=input_dict["channels"],
            sample_rate=input_dict["sample_rate"],
            alias=input_dict["alias"],
            filepath=input_dict["filepath"],
            duration=input_dict["duration"],
            noise=input_dict["beta"],
            ref_db=input_dict["ref_db"],
            **input_dict.get("noise_kwargs", {}),
        )


def _parse_beta(noise: Any) -> Union[float, str]:
    """Parse a noise colour name, "gaussian", or numeric beta exponent."""
    if isinstance(noise, str):
        if noise in NOISE_MAPPING:
            return NOISE_MAPPING[noise]
        if noise.lower() == "gaussian":
            return "gaussian"
        keys = ", ".join(NOISE_MAPPING.keys())
        raise KeyError(f"Expected a string in {keys} but got {noise}.")
    if isinstance(noise, utils.NUMERIC_DTYPES):
        return noise
    raise TypeError(f"Expected either a string or numeric input, but got {type(noise)}.")
