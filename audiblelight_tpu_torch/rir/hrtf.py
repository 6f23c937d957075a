"""Measured-HRTF binaural rendering (SimpleFreeFieldHRIR SOFA sets), in PyTorch.

Counterpart of audiblelight_tpu/rir/hrtf.py. A SOFA HRIR set is read once
(by the port's own HDF5 reader, io.hdf5), resampled to the engine rate and
kept on a device as an `HRTFSet`, used the reference's two ways:

- the direct and diffracted paths apply the full HRIR interpolated at the
  arrival direction (rir.raytracer._binaural_direct_ir,
  _synth_bent_component; rir.image_source per image);
- the stochastic tail weights each deposit by the per-band HRTF power
  |H_ear|^2 at the arrival direction (`band_power_at` on the table
  `band_powers` computes once per trace), the gains the grouped histogram
  (K5) folds.

Direction interpolation is inverse-angle-squared weighting over the 3
nearest measured directions, picked as the reference's `jax.lax.top_k`
picks them: the first k of a stable descending sort (ties to the lower
index) of the dots as XLA's CPU dot rounds them. On a regular grid a query
at a measured direction has neighbours whose dots tie but for their last
bits, so the dots must be the reference's bits, and the same on every
device (`_dots`); `torch.topk` of a float32 product only picks the
candidates (`_nearest`).
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Union

import numpy as np
import torch

from audiblelight_tpu_torch import config
from audiblelight_tpu_torch.utils import resolve_device

# Candidates beyond k that `_nearest` takes from a fast product before it
# ranks them by their exact dots
TOP_K_SLACK = 5
# How far a float32 product's dot may sit from the exact one (dots in [-1, 1])
DOT_SLACK = 1e-6


def _dots(q: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """float32 dot products of (..., 3) rows, rounded as XLA's dot rounds
    them on the CPU, fma(q2, d2, fma(q1, d1, q0 d0)): each step formed in
    double and rounded to float32, so every device gives the same bits."""
    q, d = q.to(torch.float64), d.to(torch.float64)
    s = (q[..., 0] * d[..., 0]).to(torch.float32).to(torch.float64)
    s = (q[..., 1] * d[..., 1] + s).to(torch.float32).to(torch.float64)
    return (q[..., 2] * d[..., 2] + s).to(torch.float32)


def _nearest(q: torch.Tensor, dirs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(dots, indices) (N, k) of the k directions of `dirs` (M, 3) nearest
    each query (N, 3): the first k of a stable descending sort of the exact
    dots (`_dots`), as the reference's top_k orders them (ties to the lower
    index). A float32 product picks k + TOP_K_SLACK candidates per query,
    whose exact dots rank them; every other direction's float32 dot is at
    most the last candidate's, so a query whose k-th exact dot comes within
    DOT_SLACK of it could have a rival outside the candidates, and is ranked
    over every direction."""
    m = dirs.shape[0]
    kk = min(k + TOP_K_SLACK, m)
    fast, cand = torch.topk(q @ dirs.T, kk, dim=-1)
    cand = torch.sort(cand, dim=-1).values  # index order, so the stable sort breaks ties by index
    exact = _dots(q[:, None, :], dirs[cand])
    order = torch.argsort(exact, dim=-1, descending=True, stable=True)[:, :k]
    idx, top = torch.gather(cand, 1, order), torch.gather(exact, 1, order)
    if kk < m:
        amb = top[:, -1] <= fast[:, -1] + DOT_SLACK
        if bool(amb.any()):
            full = _dots(q[amb][:, None, :], dirs[None])  # (n_amb, M)
            order = torch.argsort(full, dim=-1, descending=True, stable=True)[:, :k]
            idx[amb], top[amb] = order, torch.gather(full, 1, order)
    return top, idx


class HRTFSet:
    """A measured HRIR set at the engine sample rate, on one device.

    Attributes:
        dirs: (M, 3) float32 unit source directions in the listener frame
            (+x front, +y left, +z up; the SOFA spherical convention).
        hrirs: (M, 2, N) float32 head-related impulse responses, [left,
            right], at sample rate `sr`.
        sr: engine sample rate of the HRIRs.
    """

    def __init__(self, dirs: torch.Tensor, hrirs: torch.Tensor, sr: int):
        self.dirs = dirs.to(torch.float32)
        self.hrirs = hrirs.to(device=self.dirs.device, dtype=torch.float32)
        self.sr = int(sr)

    @classmethod
    def from_numpy(cls, dirs, hrirs, sr: int, device=None) -> "HRTFSet":
        """A set from host arrays (e.g. the JAX package's
        `np.asarray(h.dirs)`, `np.asarray(h.hrirs)`) on `device` (default
        cuda; raises without a card)."""
        dev = resolve_device(device)
        return cls(torch.as_tensor(np.array(dirs, dtype=np.float32), device=dev),
                   torch.as_tensor(np.array(hrirs, dtype=np.float32), device=dev), sr)

    @property
    def device(self) -> torch.device:
        return self.dirs.device

    def interp_weights(self, query_dirs: torch.Tensor, k: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
        """Inverse-angle-squared weights over the k nearest measured directions.

        Arguments:
            query_dirs: (..., 3) unit receiver -> source vectors.

        Returns (idx, w): (..., k) int64 indices into the set and (..., k)
        float32 weights summing to 1; an exact grid match carries nearly
        all the weight (the angle is floored at 1e-3 rad).
        """
        k = min(int(k), int(self.dirs.shape[0]))
        lead = query_dirs.shape[:-1]
        top, idx = _nearest(query_dirs.reshape(-1, 3).to(torch.float32), self.dirs, k)
        top, idx = top.reshape(*lead, k), idx.reshape(*lead, k)
        ang = torch.arccos(torch.clamp(top, -1.0, 1.0))
        w = 1.0 / torch.clamp_min(ang, 1e-3) ** 2
        return idx, w / torch.sum(w, dim=-1, keepdim=True)

    def hrirs_at(self, query_dirs: torch.Tensor) -> torch.Tensor:
        """HRIRs interpolated at arrival directions: (..., 3) -> (..., 2, N)."""
        idx, w = self.interp_weights(query_dirs)
        return torch.einsum("...k,...kcn->...cn", w, self.hrirs[idx])

    def band_powers(self, band_freqs: torch.Tensor) -> torch.Tensor:
        """Per-direction band-averaged HRTF power: (M, 2, B).

        Each band's power is the mean |H(f)|^2 over the rfft grid under the
        log-triangular band weighting of the tail synthesis, so deposits
        weighted by these powers land in the bands that re-synthesise them.
        """
        n = self.hrirs.shape[-1]
        power = torch.abs(torch.fft.rfft(self.hrirs, dim=-1)) ** 2  # (M, 2, F)
        w = _band_weights(torch.as_tensor(band_freqs, dtype=torch.float32, device=self.device),
                          n // 2 + 1, n, self.sr)  # (B, F), rows sum to 1
        return torch.einsum("mcf,bf->mcb", power, w)

    def band_power_at(self, query_dirs: torch.Tensor, band_powers_table: torch.Tensor) -> torch.Tensor:
        """Blend a `band_powers` table at arrival directions:
        (..., 3) x (M, 2, B) -> (..., 2, B)."""
        idx, w = self.interp_weights(query_dirs)
        return torch.einsum("...k,...kcb->...cb", w, band_powers_table[idx])


def _band_weights(band_freqs: torch.Tensor, n_freq: int, n_fft: int, sr: int) -> torch.Tensor:
    """(B, F) normalised log-triangular band weights on the rfft grid."""
    dev = band_freqs.device
    freqs = torch.arange(n_freq, device=dev) * (sr / n_fft)
    n_bands = band_freqs.shape[0]
    if n_bands == 1:
        w = torch.ones((1, n_freq), dtype=torch.float32, device=dev)
    else:
        logf = torch.log(torch.clamp_min(freqs, 1.0))
        logb = torch.log(band_freqs)
        idx_hi = torch.clamp(torch.searchsorted(logb, logf), 1, n_bands - 1)
        idx_lo = idx_hi - 1
        w_hi = torch.clamp((logf - logb[idx_lo]) / torch.clamp_min(logb[idx_hi] - logb[idx_lo], 1e-9), 0.0, 1.0)
        w = torch.zeros((n_bands, n_freq), dtype=torch.float32, device=dev)
        cols = torch.arange(n_freq, device=dev)
        w.index_put_((idx_lo, cols), 1.0 - w_hi, accumulate=True)
        w.index_put_((idx_hi, cols), w_hi, accumulate=True)
    return w / torch.clamp_min(torch.sum(w, dim=-1, keepdim=True), 1e-9)


# ---------------------------------------------------------------------------
# SOFA I/O
# ---------------------------------------------------------------------------


def sofa_source_dirs(positions: np.ndarray, units: str, pos_type: str) -> np.ndarray:
    """SOFA SourcePosition rows -> (M, 3) float32 unit direction vectors.

    Spherical rows are [azimuth, elevation, radius], azimuth counter-clockwise
    from +x toward +y and elevation up; cartesian rows are normalised."""
    positions = np.asarray(positions, dtype=np.float64)[:, :3]
    if pos_type.lower().startswith("cart"):
        vecs = positions
    else:
        az, el = positions[:, 0], positions[:, 1]
        if "degree" in units.lower() or not units:
            az, el = np.deg2rad(az), np.deg2rad(el)
        cos_el = np.cos(el)
        vecs = np.stack([cos_el * np.cos(az), cos_el * np.sin(az), np.sin(el)], axis=-1)
    norm = np.linalg.norm(vecs, axis=-1, keepdims=True)
    return (vecs / np.maximum(norm, 1e-12)).astype(np.float32)


def _attr_str(value) -> str:
    """A SOFA attribute as str: real files store bytes or numpy.bytes_,
    whose str() would read "b'...'" and break the 'cart' test."""
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    return str(value)


def read_hrtf_sofa(path: Union[str, Path], sr: int = config.SAMPLE_RATE) -> tuple[np.ndarray, np.ndarray]:
    """(dirs (M, 3) float32, hrirs (M, 2, N) float32 at `sr`) of a
    SimpleFreeFieldHRIR file (any SOFA FIR set of 2 receivers), resampled
    on the host when the file's rate differs."""
    from audiblelight_tpu_torch.io import hdf5
    from audiblelight_tpu_torch.io.audio import resample

    path = Path(path)
    with hdf5.File(path) as f:
        ir = np.asarray(f["Data.IR"], dtype=np.float64)  # (M, R, N)
        file_sr = float(np.asarray(f["Data.SamplingRate"]).reshape(-1)[0])
        sp = f["SourcePosition"]
        units = _attr_str(sp.attrs.get("Units", b"degree, degree, metre"))
        pos_type = _attr_str(sp.attrs.get("Type", b"spherical"))
        dirs = sofa_source_dirs(np.asarray(sp), units, pos_type)
    if ir.ndim != 3 or ir.shape[1] != 2:
        raise ValueError(f"HRTF SOFA must hold (M, 2, N) FIR data (2 ears); {path} has shape {ir.shape}")
    if int(round(file_sr)) != int(sr):
        ir = resample(ir, int(round(file_sr)), int(sr))
    return dirs, ir.astype(np.float32)


@lru_cache(maxsize=8)
def _load_cached(path: str, sr: int, device: str) -> HRTFSet:
    dirs, hrirs = read_hrtf_sofa(path, sr)
    return HRTFSet.from_numpy(dirs, hrirs, sr, device)


def load_hrtf_sofa(path: Union[str, Path], sr: int = config.SAMPLE_RATE, device=None) -> HRTFSet:
    """A SimpleFreeFieldHRIR SOFA file as an HRTFSet at sample rate `sr` on
    `device` (default cuda; raises without a card), cached per (path, sr,
    device) so repeated renders share one copy."""
    return _load_cached(str(path), int(sr), str(resolve_device(device)))


def write_hrtf_sofa(
    path: Union[str, Path],
    hrirs: np.ndarray,
    azimuths_deg: np.ndarray,
    elevations_deg: np.ndarray,
    sample_rate: float,
    radius_m: float = 1.5,
) -> Path:
    """Write a minimal SimpleFreeFieldHRIR SOFA file.

    Arguments:
        hrirs: (M, 2, N) measured pairs [left, right].
        azimuths_deg / elevations_deg: (M,) SOFA spherical angles (azimuth
            counter-clockwise from the front toward the left ear, elevation up).
    """
    from audiblelight_tpu_torch.io import hdf5

    hrirs = np.asarray(hrirs, dtype=np.float64)
    m, r, _ = hrirs.shape
    src = np.stack([np.asarray(azimuths_deg, dtype=np.float64), np.asarray(elevations_deg, dtype=np.float64),
                    np.full(m, float(radius_m))], axis=-1)
    datasets = {
        "Data.IR": hrirs,
        "Data.SamplingRate": np.array([float(sample_rate)]),
        "Data.Delay": np.zeros((1, r)),
        "SourcePosition": src,
        "ListenerPosition": np.zeros((1, 3)),
        "ReceiverPosition": np.array([[[0.0], [0.09], [0.0]], [[0.0], [-0.09], [0.0]]]),
        "ListenerUp": np.array([[0.0, 0.0, 1.0]]),
        "ListenerView": np.array([[1.0, 0.0, 0.0]]),
    }
    attrs = {
        "Conventions": "SOFA",
        "SOFAConventions": "SimpleFreeFieldHRIR",
        "SOFAConventionsVersion": "1.0",
        "DataType": "FIR",
        "Title": "audiblelight_tpu SimpleFreeFieldHRIR",
    }
    return hdf5.write_file(path, datasets, attrs,
                           {"SourcePosition": {"Type": "spherical", "Units": "degree, degree, metre"}})


__all__ = ["HRTFSet", "load_hrtf_sofa", "read_hrtf_sofa", "write_hrtf_sofa", "sofa_source_dirs"]
