"""Direction-of-arrival estimation (MUSIC) for validation and experiments.

Counterpart of audiblelight_tpu/doa.py, host numpy as there and equal to it
bit for bit: a narrowband subspace method over STFT bins, averaged across a
frequency band, used as a physics oracle that closes the loop from placement
through RIR synthesis and convolution back to the estimated source direction
(the `music_doa` entry).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from audiblelight_tpu_torch import config, utils


def steering_vectors(
    mic_xyz: np.ndarray, directions: np.ndarray, freq_hz: float, c: float = config.SPEED_OF_SOUND
) -> np.ndarray:
    """Far-field steering vectors a_c(r) = exp(+i 2 pi f / c * x_c . r).

    The +i sign encodes that a capsule displaced TOWARD the source receives the
    wavefront earlier (time advance => positive phase at the analysis frequency).

    Arguments:
        mic_xyz: (C, 3) capsule positions (relative to array centre).
        directions: (N, 3) unit direction vectors toward candidate sources.

    Returns:
        (C, N) complex steering matrix.
    """
    k = 2 * np.pi * freq_hz / c
    return np.exp(1j * k * (mic_xyz @ directions.T))


def direction_grid(n_az: int = 72, n_el: int = 18, el_range=(-40.0, 40.0)) -> np.ndarray:
    """A regular (azimuth x elevation) grid of unit vectors: (N, 3) + angles.

    Returns (N, 3) unit vectors; angles recoverable via utils.cartesian_to_polar.
    """
    az = np.linspace(-180, 180, n_az, endpoint=False)
    el = np.linspace(el_range[0], el_range[1], n_el)
    az_g, el_g = np.meshgrid(az, el, indexing="ij")
    polar = np.stack([az_g.ravel(), el_g.ravel(), np.ones(az_g.size)], axis=1)
    return utils.polar_to_cartesian(polar)


def music_spectrum(
    audio: np.ndarray,
    mic_xyz: np.ndarray,
    sr: float,
    n_sources: int = 1,
    freq_range: Tuple[float, float] = (1000.0, 4000.0),
    nfft: int = 1024,
    directions: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """MUSIC pseudo-spectrum over a direction grid.

    Arguments:
        audio: (C, S) multichannel recording.
        mic_xyz: (C, 3) capsule positions.
        n_sources: assumed source count (signal-subspace dimension).
        freq_range: band of STFT bins to average the spectrum over.

    Returns:
        (spectrum (N,), directions (N, 3)).
    """
    c_ch, s = audio.shape
    if directions is None:
        directions = direction_grid()

    hop = nfft // 2
    n_frames = max((s - nfft) // hop, 1)
    window = np.hanning(nfft)
    frames = np.stack(
        [audio[:, i * hop : i * hop + nfft] * window for i in range(n_frames)]
    )  # (F, C, nfft)
    spec = np.fft.rfft(frames, axis=-1)  # (F, C, bins)

    freqs = np.fft.rfftfreq(nfft, 1.0 / sr)
    bin_mask = (freqs >= freq_range[0]) & (freqs <= freq_range[1])
    bins = np.flatnonzero(bin_mask)

    p_music = np.zeros(directions.shape[0])
    for b in bins:
        x = spec[:, :, b].T  # (C, F)
        r = (x @ x.conj().T) / x.shape[1]  # (C, C) covariance
        w, v = np.linalg.eigh(r)
        noise_sub = v[:, : c_ch - n_sources]  # smallest eigenvalues
        a = steering_vectors(mic_xyz, directions, freqs[b])  # (C, N)
        proj = noise_sub.conj().T @ a  # (C-k, N)
        denom = np.sum(np.abs(proj) ** 2, axis=0)
        p_music += 1.0 / np.maximum(denom, 1e-12)

    return p_music / len(bins), directions


def estimate_doa(
    audio: np.ndarray,
    mic_xyz: np.ndarray,
    sr: float,
    n_sources: int = 1,
    **kwargs,
) -> np.ndarray:
    """Estimated (azimuth, elevation) degrees of the strongest source(s).

    Returns (n_sources, 2) angles sorted by spectrum peak height.
    """
    p, directions = music_spectrum(audio, mic_xyz, sr, n_sources=n_sources, **kwargs)
    # Greedy peak pick with angular suppression
    picked = []
    p_work = p.copy()
    for _ in range(n_sources):
        idx = int(np.argmax(p_work))
        picked.append(idx)
        # Suppress a 20-degree neighbourhood around the picked direction
        cos_lim = np.cos(np.deg2rad(20.0))
        near = directions @ directions[idx] > cos_lim
        p_work[near] = -np.inf
    angles = utils.cartesian_to_polar(directions[picked])[:, :2]
    return angles
