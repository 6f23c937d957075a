"""Acoustic material database: per-band absorption / scattering / transmission.

The port's copy of audiblelight_tpu/rir/materials.py (same table, same
interpolation). Values are defined at the six octave centres 125..4000 Hz and
interpolated (log-frequency, linear-alpha, edge-held) to the requested bands.
"""

from __future__ import annotations

from typing import Union

import numpy as np

# Octave band centres the table below is defined at.
TABLE_FREQS = np.array([125.0, 250.0, 500.0, 1000.0, 2000.0, 4000.0])

# name -> (absorption[6], scattering scalar, transmission loss dB @ 500 Hz)
# Absorption: standard random-incidence coefficients per octave band.
# Scattering: single broadband estimate of surface roughness.
# Transmission loss: typical published mid-band (500 Hz) sound-reduction values
# (e.g. Long, "Architectural Acoustics" partition tables); the per-band
# transmission coefficient tau = 10^(-TL/10) is extrapolated across octaves with
# the ~5 dB/octave mass-law slope in get_material_transmission.
_TABLE: dict[str, tuple[list[float], float, float]] = {
    "Default": ([0.10, 0.10, 0.10, 0.10, 0.10, 0.10], 0.5, 40.0),
    "Acoustic Tile": ([0.50, 0.70, 0.60, 0.70, 0.70, 0.50], 0.2, 25.0),
    "Brick": ([0.03, 0.03, 0.03, 0.04, 0.05, 0.07], 0.3, 48.0),
    "Brick, Painted": ([0.01, 0.01, 0.02, 0.02, 0.02, 0.03], 0.2, 48.0),
    "Carpet": ([0.01, 0.02, 0.06, 0.15, 0.25, 0.45], 0.1, 20.0),
    "Carpet, Heavy": ([0.02, 0.06, 0.14, 0.37, 0.60, 0.65], 0.15, 22.0),
    "Carpet, Heavy Padded": ([0.08, 0.24, 0.57, 0.69, 0.71, 0.73], 0.15, 24.0),
    "Tile, Ceramic": ([0.01, 0.01, 0.01, 0.01, 0.02, 0.02], 0.1, 45.0),
    "Concrete": ([0.01, 0.01, 0.02, 0.02, 0.02, 0.02], 0.1, 55.0),
    "Concrete, Rough": ([0.01, 0.02, 0.04, 0.06, 0.08, 0.10], 0.4, 55.0),
    "Concrete Block": ([0.36, 0.44, 0.31, 0.29, 0.39, 0.25], 0.3, 45.0),
    "Concrete Block, Painted": ([0.10, 0.05, 0.06, 0.07, 0.09, 0.08], 0.2, 45.0),
    "Curtain": ([0.07, 0.31, 0.49, 0.75, 0.70, 0.60], 0.3, 7.0),
    "Foliage": ([0.03, 0.06, 0.11, 0.17, 0.27, 0.31], 0.6, 5.0),
    "Glass": ([0.35, 0.25, 0.18, 0.12, 0.07, 0.04], 0.05, 27.0),
    "Glass, Heavy": ([0.18, 0.06, 0.04, 0.03, 0.02, 0.02], 0.05, 33.0),
    "Grass": ([0.11, 0.26, 0.60, 0.69, 0.92, 0.99], 0.5, 30.0),
    "Gravel": ([0.25, 0.60, 0.65, 0.70, 0.75, 0.80], 0.6, 40.0),
    "Gypsum Board": ([0.29, 0.10, 0.05, 0.04, 0.07, 0.09], 0.1, 33.0),
    "Plaster on Brick": ([0.01, 0.02, 0.02, 0.03, 0.04, 0.05], 0.2, 50.0),
    "Plaster on Concrete Block": ([0.12, 0.09, 0.07, 0.05, 0.05, 0.04], 0.2, 48.0),
    "Soil": ([0.15, 0.25, 0.40, 0.55, 0.60, 0.60], 0.5, 60.0),
    "Sound Proof": ([0.99, 0.99, 0.99, 0.99, 0.99, 0.99], 0.1, 60.0),
    "Snow": ([0.45, 0.75, 0.90, 0.95, 0.95, 0.95], 0.5, 35.0),
    "Steel": ([0.05, 0.10, 0.10, 0.10, 0.07, 0.02], 0.1, 35.0),
    "Water": ([0.01, 0.01, 0.01, 0.02, 0.02, 0.03], 0.1, 45.0),
    "wood, Thin": ([0.42, 0.21, 0.10, 0.08, 0.06, 0.06], 0.1, 20.0),
    "wood, Thick": ([0.19, 0.14, 0.09, 0.06, 0.06, 0.05], 0.1, 30.0),
    "Wood Floor": ([0.15, 0.11, 0.10, 0.07, 0.06, 0.07], 0.1, 35.0),
    "Wood On Concrete": ([0.04, 0.04, 0.07, 0.06, 0.06, 0.07], 0.1, 55.0),
}

MATERIALS = {
    name: dict(absorption=np.asarray(alpha), scattering=scatter, tl_mid_db=tl)
    for name, (alpha, scatter, tl) in _TABLE.items()
}

# Mass-law slope: transmission loss rises roughly this many dB per octave.
_TL_SLOPE_DB_PER_OCTAVE = 5.0
_TL_REF_FREQ = 500.0


def material_names() -> list[str]:
    """All valid material names."""
    return list(MATERIALS.keys())


def validate_material(material: Union[str, None]) -> str:
    """Validate a material name, defaulting to "Default" (reference :918-940)."""
    if not material:
        material = "Default"
    if material not in MATERIALS:
        raise ValueError(f"Material {material} is not a valid material.")
    return material


def get_material_absorption(material: Union[str, None], band_freqs: np.ndarray) -> np.ndarray:
    """Absorption coefficients for a material at the requested band centres.

    Log-frequency linear interpolation between table points; clamped at the edges.

    Returns:
        (n_bands,) absorption coefficients in [0, 1].
    """
    material = validate_material(material)
    alpha = MATERIALS[material]["absorption"]
    return np.interp(np.log(np.asarray(band_freqs, dtype=float)), np.log(TABLE_FREQS), alpha)


def get_material_scattering(material: Union[str, None]) -> float:
    """Broadband scattering coefficient for a material."""
    material = validate_material(material)
    return float(MATERIALS[material]["scattering"])


def get_material_transmission(
    material: Union[str, None], band_freqs: np.ndarray
) -> np.ndarray:
    """Transmission coefficients tau (fraction of non-absorbed incident energy
    that passes through the surface) at the requested band centres.

    Derived from the material's mid-band transmission loss with a mass-law
    frequency slope: TL(f) = TL(500 Hz) + 5 dB/octave * log2(f/500), then
    tau = 10^(-TL/10). Used by the tracer when the engine config's
    `transmission` flag is on (reference rlr config surface at
    tests/test_worldstate_rlr.py:810-835).

    Returns:
        (n_bands,) transmission coefficients in [0, 1].
    """
    material = validate_material(material)
    tl_mid = MATERIALS[material]["tl_mid_db"]
    f = np.asarray(band_freqs, dtype=float)
    tl = tl_mid + _TL_SLOPE_DB_PER_OCTAVE * np.log2(np.maximum(f, 1.0) / _TL_REF_FREQ)
    return np.clip(10.0 ** (-np.maximum(tl, 0.0) / 10.0), 0.0, 1.0)


def octave_band_centers(n_bands: int, fmin: float = 125.0, fmax: float = 8000.0) -> np.ndarray:
    """`n_bands` log-spaced band centres spanning [fmin, fmax].

    With n_bands=4 (the engine default, matching the reference rlr config's
    frequency_bands=4) this gives centres near 125 / 500 / 2000 / 8000 Hz.
    """
    return np.geomspace(fmin, fmax, n_bands)
