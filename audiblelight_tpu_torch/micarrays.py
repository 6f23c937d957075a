"""Microphone capsule layouts (counterpart of audiblelight_tpu/micarrays.py;
only the AmbeoVR rig the render path uses)."""

from __future__ import annotations

import numpy as np

from audiblelight_tpu_torch.utils import polar_to_cartesian

# Sennheiser AmbeoVR: 4 capsules in a tetrahedron, r = 1 cm,
# (azimuth deg, elevation deg, radius m) in the order FLU, FRD, BLD, BRU.
AMBEOVR_POLAR = np.array(
    [[45, 35, 0.01], [-45, -35, 0.01], [135, -35, 0.01], [-135, 35, 0.01]]
)
AMBEOVR_CAPSULE_NAMES = ["FLU", "FRD", "BLD", "BRU"]


def ambeovr_capsules(center) -> np.ndarray:
    """(4, 3) absolute capsule positions of an AmbeoVR centred at `center`."""
    return polar_to_cartesian(AMBEOVR_POLAR) + np.asarray(center, dtype=np.float64)[None]
