"""Small helpers shared across the port: the device rule, the host-side
sanitisers, coordinate conversions and trajectory generators the Scene uses
(copies of audiblelight_tpu/utils.py and custom_types.py, with the same draw
order), and the f32 vector helpers of the tracer."""

from __future__ import annotations

import inspect
import json
import logging
import os
import random
from functools import cached_property
from pathlib import Path
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

logger = logging.getLogger("audiblelight_tpu_torch")
if not logger.handlers:  # pragma: no cover - configured once per process
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s | %(levelname)s | %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("AUDIBLELIGHT_TORCH_LOGLEVEL", "WARNING"))

# Seed used for randomisation
SEED = 42
# Tolerance constant for approximate comparisons
SMALL = 1e-4

NUMERIC_DTYPES = (int, float, complex, np.integer, np.floating)
Numeric = Union[int, float, complex, np.integer, np.floating]
# Extensions of the foreground-audio listing, in the reference's order: a
# random file choice draws from the same list
AUDIO_EXTS = ("wav", "mp3", "mpeg4", "m4a", "flac", "aac")
# Extensions of the event-image listing, in the reference's order
IMAGE_EXTS = ("jpg", "jpeg", "png", "pdf", "gif", "tiff", "webp", "eps", "svg", "raw")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names one.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present, so a missing card never turns into a silent CPU run.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


class DistributionWrapper:
    """Wraps a callable as a distribution-like object with an `rvs()` method.
    `.max` / `.min` are cached empirical 97.5 / 2.5 percentiles."""

    N_SAMPLES = 1000

    def __init__(self, distribution: Callable):
        self.distribution = distribution

    def rvs(self, *_: Any, **__: Any) -> Numeric:
        return self.distribution()

    def __call__(self) -> Numeric:
        return self.rvs()

    @cached_property
    def max(self) -> Numeric:
        return np.nanquantile(np.array([self.rvs() for _ in range(self.N_SAMPLES)]), 0.975)

    @cached_property
    def min(self) -> Numeric:
        return np.nanquantile(np.array([self.rvs() for _ in range(self.N_SAMPLES)]), 0.025)


def coerce2d(array: Union[list, np.ndarray]) -> np.ndarray:
    """Coerce an input to a 2D numpy array (a 1D input becomes one row)."""
    if isinstance(array, list):
        array = np.array(array)
    if array.ndim == 1:
        array = array[None, :]
    if array.ndim != 2:
        raise ValueError(f"Expected a 1- or 2D array, but got {array.ndim}D array")
    return array


def seed_everything(seed: int = SEED) -> None:
    """Seed Python's, numpy's and torch's global random state."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


# Coordinates: azimuth in degrees counter-clockwise from +x (90 = left, +y),
# elevation in [-90, 90] degrees (90 = up, +z), radius in metres.


def polar_to_cartesian(spherical_array: np.ndarray) -> np.ndarray:
    """Convert (azimuth deg, elevation deg, radius) rows to Cartesian rows."""
    sph = coerce2d(np.asarray(spherical_array, dtype=float))
    if not np.all(np.abs(sph[:, 1]) <= 90):
        raise ValueError("Invalid elevation angle: expected values in [-90, 90]")
    az = np.deg2rad(sph[:, 0])
    el = np.deg2rad(sph[:, 1])
    r = sph[:, 2]
    cos_el = np.cos(el)
    return np.column_stack((r * cos_el * np.cos(az), r * cos_el * np.sin(az), r * np.sin(el)))


def cartesian_to_polar(cartesian_array: np.ndarray) -> np.ndarray:
    """Convert Cartesian rows to (azimuth deg, elevation deg, radius) rows."""
    xyz = coerce2d(np.asarray(cartesian_array, dtype=float))
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    r = np.sqrt(x**2 + y**2 + z**2)
    if not np.all(r > 0):
        raise ValueError(f"Expected radius > 0, but got radius = {r}")
    return np.column_stack((np.rad2deg(np.arctan2(y, x)), np.rad2deg(np.arcsin(z / r)), r))


def check_all_lens_equal(*iterables) -> bool:
    """True if all iterables share the same length."""
    return len({len(i) for i in iterables}) == 1


# ---------------------------------------------------------------------------
# Sanitisers
# ---------------------------------------------------------------------------


def get_project_root() -> Path:
    """The directory that holds the package (and `resources/`)."""
    return Path(__file__).resolve().parent.parent


def sanitise_filepath(filepath: Any) -> Path:
    """Validate that a file exists and coerce it to a Path."""
    if isinstance(filepath, (str, Path)):
        filepath = Path(filepath)
        if not filepath.is_file():
            raise FileNotFoundError(f"Cannot find file at {filepath}, does it exist?")
        return filepath
    raise TypeError(f"Expected filepath to be either a string or Path object, but got {type(filepath)}")


def sanitise_filepaths(filepaths: list) -> list[Path]:
    return [sanitise_filepath(fp) for fp in filepaths]


def sanitise_directory(directory: Any, create_if_missing: bool = False) -> Path:
    """Validate that a directory exists (optionally creating it) and coerce it to a Path."""
    if isinstance(directory, (str, Path)):
        directory = Path(directory)
        if not directory.is_dir():
            if create_if_missing:
                directory.mkdir(parents=True, exist_ok=True)
                return directory
            raise FileNotFoundError(f"Cannot find directory at {directory}, does it exist?")
        if not any(directory.iterdir()):
            logger.warning(f"Directory {directory} does not contain any files!")
        return directory
    raise TypeError(f"Expected directory to be either a string or Path object, but got {type(directory)}")


def sanitise_directories(directories: list, create_if_missing: bool = False) -> list[Path]:
    return [sanitise_directory(d, create_if_missing) for d in directories]


def sanitise_positive_number(x: Any, cast_to: type = float) -> Optional[Numeric]:
    """Validate that `x` is a non-negative number; coerce it to `cast_to`."""
    if isinstance(x, NUMERIC_DTYPES) and not isinstance(x, bool):
        if x >= 0.0:
            return cast_to(x)
        raise ValueError(f"Expected a positive numeric input, but got {x}")
    raise TypeError(f"Expected a positive numeric input, but got {type(x)}")


def sanitise_coordinates(x: Any) -> np.ndarray:
    """Validate that `x` is a (3,) XYZ coordinate."""
    if isinstance(x, (np.ndarray, list, tuple)):
        x = np.asarray(x, dtype=float)
        if x.shape != (3,):
            raise ValueError(f"Expected a shape of (3,), but got {x.shape}")
        return x
    raise TypeError(f"Expected a list or array input, but got {type(x)}")


def sanitise_distribution(x: Any) -> Optional[DistributionWrapper]:
    """Validate a scipy-like distribution (with `rvs`), a numeric callable, or None."""
    if x is None:
        return x
    if hasattr(x, "rvs") and callable(x.rvs):
        return DistributionWrapper(x.rvs)
    if callable(x):
        try:
            test_sample = x()
        except Exception as e:
            raise TypeError("Callable could not be evaluated during distribution validation") from e
        if isinstance(test_sample, NUMERIC_DTYPES):
            return DistributionWrapper(x)
        raise TypeError("Callable must return a numeric value to be used as a distribution")
    raise TypeError(f"Expected a distribution-like object or a callable returning floats, but got: {type(x)}")


def sample_distribution(distribution=None, override: Optional[Numeric] = None) -> float:
    """One draw from `distribution`, or the `override` when given."""
    distribution = sanitise_distribution(distribution)
    if distribution is None and override is None:
        raise ValueError("Must provide either a probability distribution to sample from or an override")
    if override is None:
        return distribution.rvs()
    if isinstance(override, NUMERIC_DTYPES):
        return override
    raise TypeError(f"Expected a numeric input for `override` but got {type(override)}")


def get_default_alias(prefix: str, objects: dict, zfill_ints: int = 3) -> str:
    """The default alias "{prefix}{count:03d}"."""
    test_alias = f"{prefix}{str(len(objects)).zfill(zfill_ints)}"
    if test_alias in objects:
        raise KeyError(f"Alias {test_alias} already exists in dictionary!")
    return test_alias


def repr_as_json(obj: object) -> str:
    """`obj.to_dict()` as indented JSON (the `__repr__` of the Scene objects)."""
    return json.dumps(obj.to_dict(), indent=4, ensure_ascii=False, sort_keys=False)


def get_valid_kwargs(func: Callable) -> set[str]:
    """Names of `func`'s keyword arguments (empty if it takes **kwargs)."""
    params = inspect.signature(func).parameters
    if any(p.kind == p.VAR_KEYWORD for p in params.values()):
        return set()
    return {n for n, p in params.items() if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)}


def validate_kwargs(func: Callable, **kwargs) -> None:
    """Raise AttributeError for a keyword `func` does not take."""
    valid_kwargs = get_valid_kwargs(func)
    if not valid_kwargs:
        raise ValueError("`func` must have at least one named keyword argument")
    for kwarg in kwargs:
        if kwarg not in valid_kwargs:
            raise AttributeError(f"`{kwarg}` is not a valid keyword argument for `{func.__name__}`")


def tiny(x) -> Numeric:
    """The smallest normal value of `x`'s float type (float32 for others)."""
    x = np.asarray(x)
    dtype = x.dtype if np.issubdtype(x.dtype, np.floating) else np.dtype(np.float32)
    return np.finfo(dtype).tiny


def pad_or_truncate_audio(audio: np.ndarray, desired_samples: Numeric, pad_mode: str = "constant") -> np.ndarray:
    """Pad or truncate a (channels, samples) array to the desired number of samples."""
    desired_samples = int(desired_samples)
    if audio.shape[1] < desired_samples:
        return np.pad(audio, ((0, 0), (0, desired_samples - audio.shape[1])), mode=pad_mode)
    if audio.shape[1] > desired_samples:
        return audio[:, :desired_samples]
    return audio


def validate_shape(shape_a: tuple, shape_b: tuple) -> None:
    """Validate two shapes are compatible; `None` entries match anything."""
    max_len = max(len(shape_a), len(shape_b))
    padded_a = tuple(shape_a) + (None,) * (max_len - len(shape_a))
    padded_b = tuple(shape_b) + (None,) * (max_len - len(shape_b))
    for i, (a, b) in enumerate(zip(padded_a, padded_b)):
        if a is not None and b is not None and a != b:
            raise ValueError(
                f"Incompatible shapes at index {i}: {a} != {b} (full shapes: {padded_a} vs {padded_b})"
            )


def coerce_nested_inputs(inp: Any) -> Any:
    """Coerce nested numpy values to JSON-serialisable Python types."""
    if isinstance(inp, dict):
        return {k: coerce_nested_inputs(v) for k, v in inp.items()} if inp else None
    if isinstance(inp, np.ndarray):
        return inp.tolist()
    if isinstance(inp, (np.floating, np.integer)):
        return inp.item()
    return inp


# ---------------------------------------------------------------------------
# Trajectory generators
# ---------------------------------------------------------------------------


def generate_linear_trajectory(xyz_start, xyz_end, n_points: int) -> np.ndarray:
    return np.linspace(np.asarray(xyz_start, float), np.asarray(xyz_end, float), n_points)


def generate_semicircular_trajectory(xyz_start, xyz_end, n_points: int) -> np.ndarray:
    """Semicircular arc between start and end, in a plane containing both."""
    xyz_start = np.asarray(xyz_start, float)
    xyz_end = np.asarray(xyz_end, float)
    chord = xyz_end - xyz_start
    midpoint = xyz_start + chord / 2
    radius = np.linalg.norm(chord) / 2
    if np.allclose(chord, 0.0):
        normal = np.array([1.0, 0.0, 0.0])
    else:
        guess = np.array([1.0, 0.0, 0.0])
        if np.cross(guess, chord).any():
            normal = np.cross(chord, guess)
        else:
            normal = np.cross(chord, np.array([0.0, 1.0, 0.0]))
        normal = normal / np.linalg.norm(normal)
    if radius == 0:
        return np.tile(xyz_start, (n_points, 1))
    vec1 = chord / (2 * radius)
    vec2 = np.cross(normal, vec1)
    angles = np.linspace(np.pi, 0, n_points)
    return midpoint + radius * (np.cos(angles)[:, None] * vec1 + np.sin(angles)[:, None] * vec2)


def generate_random_trajectory(xyz_start, max_step: Numeric, n_points: int,
                               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """3D random walk from `xyz_start`, each step at most `max_step`."""
    if max_step <= 0.0:
        raise ValueError(f"Maximum step must be greater than 0 but got {max_step}")
    rand = rng if rng is not None else np.random
    directions = rand.normal(size=(n_points - 1, 3))
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    step_lengths = rand.uniform(0, max_step, size=(n_points - 1, 1))
    walk = np.asarray(xyz_start, float) + np.cumsum(directions * step_lengths, axis=0)
    return np.vstack([xyz_start, walk])


def generate_sinusoidal_trajectory(xyz_start, xyz_end, n_points: int, amplitude: float = None,
                                   frequency: int = None,
                                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Sinusoidal trajectory between start and end (amplitude, frequency drawn if None)."""
    rand = rng if rng is not None else np.random
    if amplitude is None:
        amplitude = rand.uniform(0.01, 0.5)
    if frequency is None:
        frequency = int(rand.integers(1, 4)) if rng is not None else np.random.randint(1, 4)
    xyz_start = np.asarray(xyz_start, float)
    xyz_end = np.asarray(xyz_end, float)
    baseline = xyz_end - xyz_start
    direction = baseline / np.linalg.norm(baseline)
    if np.allclose(direction, [0, 0, 1]):
        perp1 = np.array([1.0, 0.0, 0.0])
    else:
        perp1 = np.cross(direction, [0.0, 0.0, 1.0])
        perp1 /= np.linalg.norm(perp1)
    perp2 = np.cross(direction, perp1)
    t = np.linspace(0, 1, n_points)
    points = xyz_start + np.outer(t, baseline)
    sine_wave = np.sin(2 * np.pi * frequency * t)
    return points + amplitude * (np.outer(sine_wave, perp1) + np.outer(sine_wave, perp2))


def generate_sawtooth_trajectory(xyz_start, xyz_end, n_points: int, amplitude: float = None,
                                 frequency: int = None, plane: Optional[str] = None,
                                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Sawtooth (zigzag) trajectory between start and end."""
    rand = rng if rng is not None else np.random
    if amplitude is None:
        amplitude = rand.uniform(0.01, 0.5)
    if frequency is None:
        frequency = int(rand.integers(1, 4)) if rng is not None else np.random.randint(1, 4)
    if plane is None:
        plane = rand.choice(["xy", "xz", "yz"])
    xyz_start = np.asarray(xyz_start, float)
    xyz_end = np.asarray(xyz_end, float)
    t = np.linspace(0, 1, n_points)
    trajectory = (1 - t)[:, None] * xyz_start + t[:, None] * xyz_end
    zigzag = amplitude * np.sign(np.sin(2 * np.pi * frequency * t))
    if plane in ("xy", "xz"):
        trajectory[:, 0] += zigzag
    elif plane == "yz":
        trajectory[:, 1] += zigzag
    else:
        raise ValueError(f"Invalid plane: {plane}. Must be 'xy', 'xz', or 'yz'.")
    return trajectory


# ---------------------------------------------------------------------------
# f32 vector helpers of the tracer
# ---------------------------------------------------------------------------


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, one elementwise op at a time.

    Written out (as jnp.cross and the Pallas kernels are) rather than through
    torch.cross: each product and difference is its own op, so no backend can
    contract them into fused multiply-adds and the rounding matches the
    reference's f32 arithmetic.
    """
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of a * b as ((x0 + x1) + x2), the reference's order."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def norm3(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, rounded as jnp.linalg.norm rounds it."""
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def irfft_real(spec: torch.Tensor, n: int, dim: int = -1, norm: str = "backward") -> torch.Tensor:
    """`torch.fft.irfft` over axis `dim` of a spectrum with n // 2 + 1 bins
    there, with the imaginary parts of the DC bin and (n even) the Nyquist
    bin dropped first, as the CPU's irfft drops them. cuFFT's C2R reads them: a
    linear-phase spectrum's Nyquist bin then moves a band-limited pulse's
    samples on the card by ~1e-4 of its peak."""
    spec = spec.movedim(dim, -1)
    im = spec.imag.clone()
    im[..., 0] = 0.0
    if n % 2 == 0:
        im[..., n // 2] = 0.0
    return torch.fft.irfft(torch.complex(spec.real, im), n=n, dim=-1, norm=norm).movedim(-1, dim)
