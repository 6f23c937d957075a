"""Acoustic imaging: the APGD "acoustic camera" ground truth, in PyTorch.

Counterpart of audiblelight_tpu/imaging.py. Fibonacci-lattice fields,
far-field steering operators, Tukey-windowed block-FFT visibility (spatial
covariance) matrices and an accelerated proximal gradient descent (APGD)
solve of the elastic-net acoustic imaging problem

    min_x ||Sigma - A diag(x) A^H||_F^2 + lambda (gamma ||x||_1 + (1-gamma)/2 ||x||_2^2),
    x >= 0.

Host code stays host code: the field, the steering operator, the
visibilities (complex128 until the solve) and the label half (equirect
interpolation, latitude-corrected Gaussians, segmentation) are the
reference's numpy and scipy, bit for bit. The solve runs in PyTorch on the
caller's device, complex64 throughout, as the reference's jitted programs
do: `eigh_max` (50 power steps), `_l2_grad`, `apgd_solve` (lambda
auto-tuned from one plain step, Nesterov momentum with d = 50) and
`apgd_frames`, which chains each band's frames through the warm start (on
the card one frame's solve is a CUDA graph replayed per frame). The
9 bands are one tensor axis (the reference `vmap`s them), and every (band,
frame) eigendecomposition of the stationarity normalisation is one batched
`torch.linalg.eigh` before the chain (`normalised_visibilities`), since it
does not depend on the chain. The solve is plain PyTorch on the card: the
reference has no Pallas kernel for it (a `lax.scan` of small complex
products there), so no hand-written kernel stands behind it here.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch
from scipy import ndimage
from scipy.interpolate import griddata
from scipy.signal import windows

from audiblelight_tpu_torch import config, utils

SPEED_OF_SOUND = config.SPEED_OF_SOUND


# ---------------------------------------------------------------------------
# Coordinate helpers (equirectangular <-> spherical <-> cartesian)
# ---------------------------------------------------------------------------


def _spherical_to_equirectangular(az_deg, el_deg, width, height):
    """(azimuth, elevation) degrees -> equirect pixel (x, y)."""
    x = (0.5 - az_deg / 360.0) * width % width
    y = (0.5 - el_deg / 180.0) * height
    return x, y


def _equirectangular_to_spherical(x, y, width, height):
    """Equirect pixel (x, y) -> (azimuth, elevation) degrees."""
    az = (0.5 - x / width) * 360.0
    el = 90.0 - (y / height) * 180.0
    return az, el


def _cartesian_to_spherical(x, y, z):
    """Unit vector -> (azimuth, elevation) degrees."""
    az = np.degrees(np.arctan2(y, x))
    el = np.degrees(np.arcsin(np.clip(z, -1.0, 1.0)))
    return az, el


# ---------------------------------------------------------------------------
# Field geometry (host)
# ---------------------------------------------------------------------------


def fibonacci(
    n: utils.Numeric,
    direction: Optional[np.ndarray] = None,
    fo_v: Optional[utils.Numeric] = None,
) -> np.ndarray:
    """Fibonacci-lattice sampling of the unit sphere.

    `n` is the refinement order: 4*(n+1)^2 points are generated. Optionally limit
    to a spherical cap of field-of-view `fo_v` (radians) around `direction`.

    Returns (3, m) cartesian coordinates.
    """
    if n < 0:
        raise ValueError("Parameter `n` must be non-negative.")
    if direction is not None:
        direction = np.asarray(direction, dtype=float)
        direction = direction / np.linalg.norm(direction)
        if fo_v is None:
            raise ValueError("Parameter `fo_v` must be specified if `direction` is provided.")
        if not (0 < np.rad2deg(fo_v) < 360):
            raise ValueError("Parameter `fo_v` must be in (0, 360) degrees.")

    n_px = 4 * (int(n) + 1) ** 2
    idx = np.arange(n_px)
    colat = np.arccos(1 - (2 * idx + 1) / n_px)
    lon = (4 * np.pi * idx) / (1 + np.sqrt(5))

    lat = np.pi / 2 - colat
    xyz = np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], axis=0
    )

    if direction is not None:
        mask = (direction @ xyz) >= np.cos(fo_v / 2)
        xyz = xyz[:, mask]
    return xyz


def get_field(sh_order: Optional[utils.Numeric] = config.AIMG_SH_ORDER) -> np.ndarray:
    """Full-sphere Fibonacci field at the given SH order: (3, n_px) coordinates.
    No polar trim: `generate_acoustic_image_json` rebuilds the tesselation from
    the row count 4*(sh_order+1)^2."""
    return fibonacci(sh_order)


def steering_operator(
    xyz: np.ndarray,
    r: np.ndarray,
    fmin: Optional[utils.Numeric] = config.AIMG_FMIN,
    fmax: Optional[utils.Numeric] = config.AIMG_FMAX,
    n_bands: Optional[utils.Numeric] = config.AIMG_NBANDS,
) -> np.ndarray:
    """Far-field steering matrix A = exp(-i * 2pi/wl * X^T R).

    Arguments:
        xyz: (3, C) capsule positions.
        r: (3, N) field directions.

    Returns:
        (C, N) complex steering matrix at the band-top wavelength.
    """
    freq = np.linspace(fmin, fmax, n_bands)
    wl = SPEED_OF_SOUND / (freq.max() + 500)
    if wl <= 0:
        raise ValueError(f"Parameter `wl` must be positive (got {wl}).")
    scale = 2 * np.pi / wl
    return np.exp((-1j * scale * xyz.T) @ r)


# ---------------------------------------------------------------------------
# Visibility (spatial covariance) extraction (host)
# ---------------------------------------------------------------------------


def extract_visibilities(
    data_: np.ndarray,
    rate_: utils.Numeric,
    t: utils.Numeric,
    fc: utils.Numeric,
    bw: utils.Numeric,
    alpha: utils.Numeric,
) -> np.ndarray:
    """Per-STI-frame visibility matrices for one frequency band.

    Tukey-windowed block FFT; band bins [fc-bw/2, fc+bw/2] are collapsed and the
    outer product X^H X forms the (C x C) visibility per frame.

    Returns (n_frames, C, C) complex.
    """
    n_stft_sample = int(rate_ * t)
    if n_stft_sample == 0:
        raise ValueError("Not enough samples per time frame.")

    n_sample = (data_.shape[0] // n_stft_sample) * n_stft_sample
    n_channel = data_.shape[1]
    blocks = data_[:n_sample].reshape(-1, n_stft_sample, n_channel)

    window = windows.tukey(M=n_stft_sample, alpha=alpha, sym=True).reshape(1, -1, 1)
    spec = np.fft.fft(blocks * window, axis=1)

    idx_start = int((fc - 0.5 * bw) * n_stft_sample / rate_)
    idx_end = int((fc + 0.5 * bw) * n_stft_sample / rate_)
    collapsed = np.sum(spec[:, idx_start : idx_end + 1, :], axis=1)  # (F, C)

    return collapsed[:, :, None].conj() * collapsed[:, None, :]


def form_visibility(
    data: np.ndarray,
    rate: utils.Numeric,
    fc: utils.Numeric,
    bw: utils.Numeric,
    t_sti: utils.Numeric,
    t_stationarity: utils.Numeric,
) -> np.ndarray:
    """Stationarity-pooled visibilities: sum STI frames into stationary blocks."""
    s_sti = extract_visibilities(data, rate, t_sti, fc, bw, alpha=1.0)
    n_block = int(t_stationarity / t_sti)
    n_out = s_sti.shape[0] // n_block
    return s_sti[: n_out * n_block].reshape(n_out, n_block, *s_sti.shape[1:]).sum(axis=1)


# ---------------------------------------------------------------------------
# APGD solver (device)
# ---------------------------------------------------------------------------


def _complex64(x, device: torch.device) -> torch.Tensor:
    """A complex64 tensor on `device` from a complex array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.complex64)
    return torch.as_tensor(np.asarray(x, dtype=np.complex64), device=device)


def _gram_diag(a: torch.Tensor, a_conj: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Re(diag(A^H M A)) over the field: sum over capsules of conj(A) * (M @ A),
    (..., N) real. `m` is (..., C, C)."""
    return torch.sum(a_conj * (m @ a), dim=-2).real


def eigh_max(a, device=None) -> float:
    """Largest eigenvalue of B = (conj(A) . A)^H (conj(A) . A) by 50 power
    steps from ones / sqrt(n) (a 1e-30 floor on the norm), in complex64 on
    `device` (default `cuda`; raises without a card).

    This is the Lipschitz-constant ingredient for the APGD step size.
    """
    dev = utils.resolve_device(device)
    a_j = _complex64(a, dev)
    a_conj, a_h = a_j.conj(), a_j.conj().T

    def matvec(v):
        return _gram_diag(a_j, a_conj, (a_j * v) @ a_h)

    n = a_j.shape[1]
    v = torch.ones(n, dtype=torch.float32, device=dev) / torch.sqrt(torch.tensor(float(n), device=dev))
    for _ in range(50):
        w = matvec(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=1e-30)
    return float(torch.dot(v, matvec(v)))


def _l2_grad(x: torch.Tensor, sigma: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Gradient of ||Sigma - A diag(x) A^H||_F^2 w.r.t. x; `x` is (..., N) and
    `sigma` (..., C, C), batched over the leading axes."""
    residual = sigma - (a * x[..., None, :]) @ a.conj().T
    return -2.0 * _gram_diag(a, a.conj(), residual)


def _beta(k: int, d: int) -> float:
    """The momentum weight (k - 1) / (k + d), rounded as float32 arithmetic."""
    return float(np.float32(k - 1.0) / np.float32(k + d))


def apgd_solve(
    sigma: torch.Tensor,
    a: torch.Tensor,
    l_: torch.Tensor,
    x0: torch.Tensor,
    lambda_: Optional[torch.Tensor] = None,
    gamma: float = 0.5,
    n_iter: int = 50,
    d: int = 50,
) -> torch.Tensor:
    """Accelerated proximal gradient descent for one visibility matrix (or a
    batch: `sigma` (..., C, C), `x0` (..., N)).

    Fixed-iteration Nesterov-accelerated forward-backward splitting with the
    elastic-net + nonnegativity prox. When `lambda_` is None, it is auto-tuned
    with the reference's procedure (one plain gradient step bounds the intensity
    scale; lambda = max/(10 * alpha * gamma), per batch row). Tensors share one
    device; `sigma` and `a` complex64, `l_` and `x0` float32.
    """
    alpha = 1.0 / l_
    if lambda_ is None:
        x_probe = torch.clamp(x0 - alpha * _l2_grad(x0, sigma, a), min=0.0)
        lambda_ = torch.amax(x_probe, dim=-1, keepdim=True) / (10.0 * alpha * gamma)

    shrink = alpha * lambda_ * gamma
    denom = 1.0 + alpha * lambda_ * (1.0 - gamma)
    x_prev, y = x0, x0
    for k in range(1, n_iter + 1):
        z = y - alpha * _l2_grad(y, sigma, a)
        x = torch.clamp(z - shrink, min=0.0) / denom  # elastic-net + nonneg prox
        y = x + _beta(k, d) * (x - x_prev)
        x_prev = x
    return x_prev


def normalised_visibilities(sigmas: torch.Tensor) -> torch.Tensor:
    """Each visibility's eigenvalues scaled to [0, 1] by its largest (all
    zero where that is <= 0): V diag(d_n) V^H, for every (..., C, C) matrix in
    one batched `torch.linalg.eigh` (ascending eigenvalues, the lower
    triangle read; the matrices are Hermitian bit for bit)."""
    d, v = torch.linalg.eigh(sigmas)
    d_max = torch.amax(d, dim=-1, keepdim=True)
    d_n = torch.where(d_max <= 0, torch.zeros_like(d), torch.clamp(d / torch.clamp(d_max, min=1e-30), min=0.0))
    return (v * d_n[..., None, :]) @ v.conj().transpose(-1, -2)


def apgd_frames_eager(s_norm: torch.Tensor, a: torch.Tensor, l_: torch.Tensor, n_iter: int = 50) -> torch.Tensor:
    """APGD over every frame of every band, each frame warm-started from the
    band's last: `s_norm` (bands, frames, C, C) normalised visibilities,
    `a` (C, N). Returns (bands, frames, N) float32. Each iteration launches
    its ~18 small ops one by one."""
    n_bands, n_frames = s_norm.shape[:2]
    x = torch.zeros(n_bands, a.shape[1], dtype=torch.float32, device=s_norm.device)
    out = torch.empty(n_bands, n_frames, a.shape[1], dtype=torch.float32, device=s_norm.device)
    for f in range(n_frames):
        x = apgd_solve(s_norm[:, f], a, l_, x, gamma=0.5, n_iter=n_iter)
        out[:, f] = x
    return out


def _apgd_frames_graph(s_norm: torch.Tensor, a: torch.Tensor, l_: torch.Tensor, n_iter: int) -> torch.Tensor:
    """`apgd_frames_eager` on the card with one frame's solve (the lambda
    probe and its n_iter iterations) captured once as a CUDA graph and
    replayed per frame: the same kernels on the same inputs, so the same
    bits, without the host's ~20 us before each of ~900 launches a frame."""
    n_bands, n_frames = s_norm.shape[:2]
    dev = s_norm.device
    s_buf = s_norm[:, 0].clone()
    x_buf = torch.zeros(n_bands, a.shape[1], dtype=torch.float32, device=dev)
    side = torch.cuda.Stream(dev)  # warm-up off the capture, as CUDA graphs require
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        apgd_solve(s_buf, a, l_, x_buf, gamma=0.5, n_iter=n_iter)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x_out = apgd_solve(s_buf, a, l_, x_buf, gamma=0.5, n_iter=n_iter)
    out = torch.empty(n_bands, n_frames, a.shape[1], dtype=torch.float32, device=dev)
    for f in range(n_frames):
        s_buf.copy_(s_norm[:, f])
        graph.replay()
        out[:, f] = x_out
        x_buf.copy_(x_out)
    return out


def apgd_frames(s_norm: torch.Tensor, a: torch.Tensor, l_: torch.Tensor, n_iter: int = 50) -> torch.Tensor:
    """APGD over every frame of every band, each frame warm-started from the
    band's last: `s_norm` (bands, frames, C, C) normalised visibilities,
    `a` (C, N) on one device. Returns (bands, frames, N) float32. On the
    card one frame's solve is a CUDA graph replayed per frame
    (`_apgd_frames_graph`, bit for bit `apgd_frames_eager`); on the CPU the
    eager loop runs."""
    if s_norm.is_cuda and s_norm.shape[1] > 0:
        return _apgd_frames_graph(s_norm, a, l_, n_iter)
    return apgd_frames_eager(s_norm, a, l_, n_iter)


def _apgd_band(sigmas, a, l_, n_iter: int = 50, device=None) -> torch.Tensor:
    """APGD over all frames of one band, warm-starting each frame from the
    last: `sigmas` (frames, C, C). Returns (frames, N) on `device`."""
    dev = utils.resolve_device(device)
    s_norm = normalised_visibilities(_complex64(sigmas, dev))
    l_t = torch.as_tensor(l_, dtype=torch.float32, device=dev)
    return apgd_frames(s_norm[None], _complex64(a, dev), l_t, n_iter=n_iter)[0]


# ---------------------------------------------------------------------------
# Orchestration
# ---------------------------------------------------------------------------


def _mel_frequencies(n: int, fmin: float, fmax: float) -> np.ndarray:
    """Mel-spaced frequencies (Slaney-style htk=False formula)."""

    def hz_to_mel(f):
        f = np.asarray(f, dtype=float)
        f_sp = 200.0 / 3
        mels = f / f_sp
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=float)
        f_sp = 200.0 / 3
        freqs = f_sp * m
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = np.log(6.4) / 27.0
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)

    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n))


def band_frequencies(nbands: int, fmin, fmax, scale: str) -> np.ndarray:
    """The bands' centre frequencies on a linear or mel ("log") scale."""
    if fmin >= fmax:
        raise ValueError(
            f"Minimum frequency must be smaller than maximum frequency "
            f"(current minimum: {fmin}, maximum: {fmax})."
        )
    if scale == "linear":
        return np.linspace(fmin, fmax, nbands)
    if scale == "log":
        return _mel_frequencies(nbands, fmin, fmax)
    raise ValueError(
        f"'{scale}' is not a valid scale to generate covariance matrices "
        f"(must be either 'log' or 'linear')"
    )


def band_visibilities(audio_in: np.ndarray, freq: np.ndarray, sr, bw, t_sti, frame_cap) -> np.ndarray:
    """Host: each band's stationarity-pooled visibilities (10 STI frames a
    block), capped at `frame_cap` frames and cut to the shortest band:
    (bands, frames, C, C) complex128."""
    t_stationarity = 10 * t_sti
    sigmas = []
    for fc in freq:
        s = form_visibility(audio_in, sr, fc, bw, t_sti, t_stationarity)
        if frame_cap:
            s = s[:frame_cap]
        sigmas.append(s)
    min_frames = min(s.shape[0] for s in sigmas)
    return np.stack([s[:min_frames] for s in sigmas])


def get_visibility_matrix(
    audio_in: np.ndarray,
    micarray_coords: np.ndarray,
    sr: Optional[utils.Numeric] = config.SAMPLE_RATE,
    t_sti: Optional[utils.Numeric] = config.AIMG_TSTI,
    scale: Optional[str] = config.AIMG_SCALE,
    nbands: Optional[utils.Numeric] = config.AIMG_NBANDS,
    frame_cap: Optional[utils.Numeric] = config.AIMG_FRAME_CAP,
    fmin: Optional[utils.Numeric] = config.AIMG_FMIN,
    fmax: Optional[utils.Numeric] = config.AIMG_FMAX,
    bw: Optional[utils.Numeric] = config.AIMG_BANDWIDTH,
    sh_order: Optional[utils.Numeric] = config.AIMG_SH_ORDER,
    n_jobs: Optional[utils.Numeric] = None,  # accepted for API parity; unused
    verbosity: Optional[utils.Numeric] = None,  # accepted for API parity; unused
    n_iter: int = 50,
    device=None,
) -> np.ndarray:
    """Compute the APGD acoustic image for multichannel audio.

    Arguments:
        audio_in: (samples, channels) audio.
        micarray_coords: (capsules, 3) polar capsule coordinates (az, el, dist).
        device: where the solve runs (default `cuda`; raises without a card).

    Returns:
        (tesselation, bands, frames) float32 acoustic image.
    """
    freq = band_frequencies(nbands, fmin, fmax, scale)
    dev = utils.resolve_device(device)

    # Field + steering operator (host), the step size's eigenvalue (device)
    r = get_field(sh_order)
    mic_xyz = utils.polar_to_cartesian(np.asarray(micarray_coords)).T  # (3, C)
    a = steering_operator(mic_xyz, r, fmin=fmin, fmax=fmax, n_bands=nbands)
    a_t = _complex64(a, dev)
    l_ = torch.tensor(2.0 * eigh_max(a_t, dev), dtype=torch.float32, device=dev)

    sigmas = band_visibilities(audio_in, freq, sr, bw, t_sti, frame_cap)  # (B, F, C, C) complex128
    s_norm = normalised_visibilities(_complex64(sigmas, dev))
    xs = apgd_frames(s_norm, a_t, l_, n_iter=n_iter)  # (bands, frames, n_px)
    return xs.permute(2, 0, 1).cpu().numpy()  # (tesselation, bands, frames)


# ---------------------------------------------------------------------------
# Label generation (host)
# ---------------------------------------------------------------------------


def create_target_grid(width: utils.Numeric, height: utils.Numeric) -> np.ndarray:
    """Regular equirect (azimuth, elevation) target grid of shape (W*H, 2)."""
    target_az = np.linspace(180, -180, utils.sanitise_positive_number(width, cast_to=int))
    target_el = np.linspace(90, -90, utils.sanitise_positive_number(height, cast_to=int))
    az_grid, el_grid = np.meshgrid(target_az, target_el, indexing="xy")
    return np.stack([az_grid.ravel(), el_grid.ravel()], axis=1)


def create_2d_gaussian(
    cx: utils.Numeric,
    cy: utils.Numeric,
    width: utils.Numeric,
    height: utils.Numeric,
    circle_radius: utils.Numeric = config.AIMG_CIRCLE_RADIUS_DEG,
) -> np.ndarray:
    """Latitude-corrected 2D Gaussian at pixel (cx, cy) on an equirect canvas.

    The circle radius contains ~2 SD of the mass; azimuth deltas wrap and are
    scaled by cos(latitude) so the footprint is isotropic on the sphere.
    """
    if not 0 <= cx <= width:
        raise ValueError(f"X coordinate is outside of width! (x = {cx}, width = {width})")
    if not 0 <= cy <= height:
        raise ValueError(f"Y coordinate is outside of height! (y = {cy}, height = {height})")

    sigma_deg = circle_radius / 2.0
    deg_per_pixel_x = 360.0 / width
    deg_per_pixel_y = 180.0 / height
    _, center_el_deg = _equirectangular_to_spherical(cx, cy, width=width, height=height)

    xx, yy = np.meshgrid(np.arange(width), np.arange(height), indexing="xy")
    dx = (xx - cx + width / 2) % width - width / 2  # wrapped, signed
    dy = yy - cy
    delta_az = -dx * deg_per_pixel_x
    delta_el = dy * deg_per_pixel_y
    cos_lat = np.cos(np.radians(center_el_deg))
    dist_sq = delta_el**2 + (cos_lat * delta_az) ** 2
    return np.exp(-dist_sq / (2.0 * sigma_deg**2))


def find_segmentations(acoustic_image: np.ndarray) -> list[list[list]]:
    """Connected components of the nonzero mask, as filled pixel lists.

    Each component yields [[x, y, amplitude], ...]; single-pixel components
    are dropped. A blob split across the left/right equirect edges gives two
    components.
    """
    mask = acoustic_image > 0
    labelled, n_comp = ndimage.label(mask)
    out = []
    for comp in range(1, n_comp + 1):
        ys, xs = np.where(labelled == comp)
        if len(xs) < 2:
            continue
        amps = acoustic_image[ys, xs]
        out.append([[int(x), int(y), float(ampl)] for x, y, ampl in zip(xs, ys, amps)])
    return out


def generate_acoustic_image_json(
    acoustic_image: np.ndarray,
    metadata: np.ndarray,
    resolution: Optional[tuple] = config.AIMG_RESOLUTION,
    polygon_mask_threshold: Optional[utils.Numeric] = config.AIMG_POLYGON_MASK_THRESHOLD,
    circle_radius: Optional[utils.Numeric] = config.AIMG_CIRCLE_RADIUS_DEG,
) -> list[dict]:
    """Segmentation labels for an acoustic image, one dict per (frame, event):
    band-median the image, interpolate each annotated frame onto an equirect
    canvas, weight by a Gaussian at the ground-truth direction, threshold,
    and emit per-blob pixel lists. `metadata` holds DCASE rows [frame, class,
    source, azimuth, elevation, distance]."""
    if not acoustic_image.ndim == 3:
        raise ValueError(
            f"Expected acoustic image to have 3 dimensions, but got {acoustic_image.shape}"
        )

    scene_res = []
    n_tesselation, _, _ = acoustic_image.shape
    medianed = np.median(acoustic_image, axis=1)  # (tesselation, frames)

    # Infer sh_order back from the tesselation size: n_px = 4*(order+1)^2
    sh_order = int(math.sqrt(n_tesselation) / 2 - 1)
    tess = fibonacci(sh_order).T
    tess_eq = np.stack([_cartesian_to_spherical(*p) for p in tess])

    video_width, video_height = resolution
    target_points = create_target_grid(video_width, video_height)

    for frame_idx in np.unique(metadata[:, 0]):
        frame = medianed[:, int(frame_idx)] if int(frame_idx) < medianed.shape[1] else None
        if frame is None:
            continue
        interpolated = griddata(
            tess_eq, frame, target_points, method="linear", fill_value=0.0
        ).reshape(video_height, video_width)

        for row in metadata[metadata[:, 0] == frame_idx]:
            _, class_id, instance_id, gt_az, gt_el, gt_dist = row[:6]
            gt_x, gt_y = _spherical_to_equirectangular(
                gt_az, gt_el, width=video_width, height=video_height
            )
            gauss = create_2d_gaussian(
                gt_x, gt_y, width=video_width, height=video_height, circle_radius=circle_radius
            )
            scaled = interpolated * gauss
            scaled = np.where(scaled < polygon_mask_threshold, 0.0, scaled)

            scene_res.append(
                {
                    "metadata_frame_index": int(frame_idx),
                    "instance_id": int(instance_id),
                    "category_id": int(class_id),
                    "segmentation": find_segmentations(scaled),
                    "distance": float(gt_dist),
                }
            )

    return scene_res


def sigmoid(x: Union[np.ndarray, utils.Numeric]):
    """Numerically-stable sigmoid mapping into [0, 1]."""
    return np.exp(-np.logaddexp(0, -np.asarray(x, dtype=float)))


def standardise_acoustic_image_amplitude(acoustic_image_labels: list[dict]) -> list[dict]:
    """Z-score segmentation amplitudes against the STARSS23 training
    distribution (hardcoded mu/sigma), then sigmoid into [0, 1]."""
    mu, sig = config.AIMG_STARSS23_MU, config.AIMG_STARSS23_SIGMA
    res = []
    for aimg in acoustic_image_labels:
        new_polys = []
        for poly in aimg["segmentation"]:
            poly_arr = np.array(poly, dtype=float)
            poly_arr[:, -1] = sigmoid((poly_arr[:, -1] - mu) / sig)
            new_polys.append(poly_arr.tolist())
        aimg["segmentation"] = new_polys
        res.append(aimg)
    return res
