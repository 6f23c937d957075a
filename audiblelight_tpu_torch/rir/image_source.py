"""Shoebox image-source RIR engine (Allen & Berkley), frequency domain, PyTorch.

Counterpart of audiblelight_tpu/rir/image_source.py, with its arithmetic:

  * every image of the cube |n_x|, |n_y|, |n_z| <= max_order (8 per cell)
    adds g_k(f) * exp(-i w_f tau_k) to the spectrum, so fractional delays
    are exact and band-limited, and the wall absorption is frequency
    dependent per image: g_k(f) = exp(m_k . log_beta(f)), the log-betas
    interpolated piecewise-linearly in log f from the bands to the bins;
  * the phase keeps float32 exact at any f * d: the sample delay splits
    into an integer part d and a fraction, and (f * d) mod n_samples is
    computed in int32 as ((((f * d_hi) mod n) << 8) mod n + f * d_lo) mod n
    with d = 256 d_hi + d_lo;
  * images whose delay is at or beyond n_samples - 1 add nothing (with a
    measured HRTF set, beyond n_samples minus its HRIR length); the
    spectrum sums in (real, imaginary) float32 pairs, as complex64 does, and
    the IRs are its irfft (`utils.irfft_real`: the CPU's, on any device).

The reference scans fixed chunks of 1,024 images, which XLA fuses into one
pass. Here the per-image quantities (`image_terms`: distances, amplitudes,
delays, receiver gains) are formed in PyTorch, and the (image, bin) sum
runs where the sources lie. On a card, for omni and ambisonic rigs, it is
one hand-written kernel over all images (`ops.cuda_kernels.shoebox_ism`,
csrc/shoebox_ism.cu), whose terms never leave registers. On the CPU, and for
the binaural rigs, it is the eager block loop (`shoebox_rirs_plain`, the
kernel's plain version): each step a tensor of (listeners, emitters, images,
bins), so the images (and, where one image of every emitter would not fit,
the emitters) are taken in blocks chosen from a byte budget for that live
set; buffers are reused in place. Blocks and the kernel's splits change the
sums' order only, so the result does not depend on them beyond rounding.
Each image distance is a square root rounded once from double and the irfft
drops the Nyquist bin's imaginary part on every device, so a card and a CPU
form the same delays and IRs (to ~1e-7 of peak).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from audiblelight_tpu_torch import config
from audiblelight_tpu_torch.ops.cuda_kernels import shoebox_ism
from audiblelight_tpu_torch.profiling import annotate, count
from audiblelight_tpu_torch.rir.hrtf import HRTFSet
from audiblelight_tpu_torch.rir.sh import (
    HEAD_RADIUS_M,
    ambisonic_encoding_gains,
    encoding_channels,
    spherical_head_shadow,
    woodworth_itd,
)
from audiblelight_tpu_torch.utils import irfft_real, resolve_device

# Live bytes per (listener, emitter, image, bin) term at the peak of one
# block. Omni and ambisonics hold three float32 tensors of the block (the
# phase, then cos and sin, and the amplitude-gain product): 12 B on the CPU,
# 20 B measured on an H100 (3.36-3.46 GiB at 2 GiB / 12 B blocks); the
# binaural head adds each ear's shadow, phase and transfer function; a
# measured HRTF set ("hrtf") each ear's interpolated HRIR spectrum, 33 B
# measured on an H100 (1.368 GiB at 2 GiB / 48 B blocks).
TERM_BYTES = {"binaural": 48, "hrtf": 33}
TERM_BYTES_DEFAULT = 20
# The live-set budget of one block: a few GB on a card, less on a host that
# others share
CARD_LIVE_BYTES = 2 << 30
CPU_LIVE_BYTES = 256 << 20
# The encodings the kernel takes on a card: one unit-gain channel per
# listener row, or an ambisonic layout of 1, 4, 9 or 16 channels
KERNEL_ENCODINGS = ("omni", "foa", "sh0", "sh1", "sh2", "sh3")


def _image_grid(max_order: int) -> tuple[np.ndarray, np.ndarray]:
    """All (n, q) image indices of the cube |n_x|, |n_y|, |n_z| <= max_order:
    n (K, 3) int32 cell indices and q (K, 3) int32 mirror flags in {0, 1},
    K = 8 (2 max_order + 1)^3, in the reference's order."""
    rng = np.arange(-max_order, max_order + 1)
    n = np.stack(np.meshgrid(rng, rng, rng, indexing="ij"), axis=-1).reshape(-1, 3)
    q = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), axis=-1).reshape(-1, 3)
    n_rep = np.repeat(n, 8, axis=0)
    q_rep = np.tile(q, (len(n), 1))
    return n_rep.astype(np.int32), q_rep.astype(np.int32)


def _band_to_bins(freqs_hz: torch.Tensor, band_freqs: torch.Tensor) -> torch.Tensor:
    """(F, B) weights from the B bands to the F bins: piecewise-linear in
    log f between the two bands around each bin, held at the edges."""
    n_freq, n_bands = freqs_hz.shape[0], band_freqs.shape[0]
    if n_bands == 1:
        return torch.ones((n_freq, 1), dtype=torch.float32, device=freqs_hz.device)
    logf = torch.log(torch.clamp_min(freqs_hz, float(band_freqs[0]) * 0.5))
    logb = torch.log(band_freqs)
    idx_hi = torch.clamp(torch.searchsorted(logb, logf), 1, n_bands - 1)
    idx_lo = idx_hi - 1
    w_hi = torch.clamp((logf - logb[idx_lo]) / torch.clamp_min(logb[idx_hi] - logb[idx_lo], 1e-9), 0.0, 1.0)
    interp = torch.zeros((n_freq, n_bands), dtype=torch.float32, device=freqs_hz.device)
    rows = torch.arange(n_freq, device=freqs_hz.device)
    interp[rows, idx_lo] += 1.0 - w_hi
    interp[rows, idx_hi] += w_hi
    return interp


def _matmul_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, J) @ b (J, N) for a small J, as J broadcast multiply-adds in
    float32 (no TF32, whatever the matmul settings)."""
    out = a[:, :1] * b[:1]
    for j in range(1, a.shape[1]):
        out = out + a[:, j : j + 1] * b[j : j + 1]
    return out


def block_shape(n_rows: int, n_emitters: int, n_freq: int, n_images: int, encoding: str,
                chunk: Optional[int], max_bytes: int) -> tuple:
    """(emitters per block, images per block) that keep one block's live
    set, n_rows * emitters * images * n_freq terms, within `max_bytes`
    (one emitter and one image at least). `chunk` fixes the images per
    block; the emitters then fill what is left."""
    terms = max(1, int(max_bytes) // TERM_BYTES.get(encoding, TERM_BYTES_DEFAULT))
    per = n_rows * n_freq
    if chunk is None:
        e_blk = min(n_emitters, max(1, terms // per))
        chunk = min(n_images, max(1, terms // (per * e_blk)))
    else:
        chunk = min(n_images, max(1, int(chunk)))
        e_blk = min(n_emitters, max(1, terms // (per * chunk)))
    return int(e_blk), int(chunk)


def image_terms(src: torch.Tensor, lis: torch.Tensor, mirror: torch.Tensor, shift: torch.Tensor, sr: int,
                c: float, in_range: int, n_samples: int) -> tuple:
    """The sum's quantities per (listener row, emitter, image), for emitters
    `src` (e, 3), rows `lis` (R, 3) and the images' mirror signs and shifts
    (k, 3): (vec, dist, amp, d_frac, d_mod), vec (R, e, k, 3) the row to
    image vectors and the others (R, e, k): the distance (a square root
    rounded once from double), 1 / (4 pi max(dist, 1e-2)) masked to zero
    where the delay is at or beyond `in_range`, and the delay's fraction and
    integer part mod n_samples (int32). Elementwise: a block of emitters or
    images gets the bits of the whole set."""
    img = mirror[None] * src[:, None, :] + shift[None]  # (e, k, 3)
    vec = img[None] - lis[:, None, None, :]  # (R, e, k, 3)
    sq = vec * vec
    # Rounded once from double: the card's float sqrt can be 1 ulp off the
    # CPU's, and a delay's last bits move a band-limited pulse's samples
    dist = torch.sqrt((sq[..., 0] + sq[..., 1] + sq[..., 2]).double()).float()
    amp = 1.0 / ((4.0 * math.pi) * torch.clamp_min(dist, 1e-2))
    delay = dist * (sr / c)
    amp = amp * (delay < in_range)
    d_int = torch.floor(delay).to(torch.int32)
    return vec, dist, amp, delay - d_int.to(torch.float32), torch.remainder(d_int, n_samples)


def image_directions(vec: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """(e, k, 3) unit receiver -> image directions of the first listener row."""
    return vec[0] / torch.clamp_min(dist[0, ..., None], 1e-9)


def shoebox_rirs(
    room_dims,
    source_pos,
    listener_pos,
    wall_log_beta,
    band_freqs,
    n_samples: int,
    max_order: int = 8,
    sr: int = config.SAMPLE_RATE,
    c: float = config.SPEED_OF_SOUND,
    encoding: str = "omni",
    chunk: Optional[int] = None,
    hrtf=None,
    device=None,
) -> torch.Tensor:
    """Shoebox RIRs of every (listener, source) pair.

    On a CUDA device the omni and ambisonic encodings ("omni", "foa",
    "sh0"-"sh3") take the image-source kernel (`ops.cuda_kernels.
    shoebox_ism`, on the quantities of `image_terms` over all images at
    once); on the CPU, and for "binaural" on any device, the eager block
    loop (`shoebox_rirs_plain`) runs.

    Arguments:
        room_dims: (3,) room dimensions Lx, Ly, Lz in metres; the room spans
            [0, L] per axis.
        source_pos: (E, 3) source positions inside the room.
        listener_pos: (C, 3) listener (capsule) positions. The encodings
            other than "omni" render the first listener only.
        wall_log_beta: (6, B) log reflection coefficients per wall and band,
            walls ordered [x0, xL, y0, yL, z0, zL]; log(beta) = 0.5 log(1 - alpha).
        band_freqs: (B,) band centre frequencies of the coefficients.
        n_samples: IR length in samples.
        max_order: image order per axis.
        encoding: "omni" (one channel per listener), "foa" (4, AmbiX), "sh{N}"
            ((N+1)^2, ACN/SN3D) or "binaural" (2, the analytic spherical head).
        chunk: images per block of the block loop (default: the most that
            keep a block's live set within CARD_LIVE_BYTES, or CPU_LIVE_BYTES
            on the CPU); the kernel takes no blocks.
        hrtf: a measured HRTF set (`rir.hrtf.HRTFSet`) for "binaural": each
            image's arrival blends its 3 nearest HRIRs, whose spectrum
            multiplies the image's contribution per ear; an image whose
            HRIR would not fit before n_samples adds nothing.
        device: where to run when `source_pos` is not a tensor (default
            cuda; raises without a card). A tensor's own device wins.

    Returns:
        (C_out, E, n_samples) float32 IRs on the device; C_out = C for omni,
        4 for foa, (N+1)^2 for sh{N}, 2 for binaural.
    """
    return _shoebox(room_dims, source_pos, listener_pos, wall_log_beta, band_freqs, n_samples, max_order, sr, c,
                    encoding, chunk, hrtf, device, kernel=True)


def shoebox_rirs_plain(
    room_dims,
    source_pos,
    listener_pos,
    wall_log_beta,
    band_freqs,
    n_samples: int,
    max_order: int = 8,
    sr: int = config.SAMPLE_RATE,
    c: float = config.SPEED_OF_SOUND,
    encoding: str = "omni",
    chunk: Optional[int] = None,
    hrtf=None,
    device=None,
) -> torch.Tensor:
    """`shoebox_rirs` by the eager block loop on any device: the
    image-source kernel's plain version, and the engine itself on the CPU
    and for binaural rigs. Arguments and result as `shoebox_rirs`."""
    return _shoebox(room_dims, source_pos, listener_pos, wall_log_beta, band_freqs, n_samples, max_order, sr, c,
                    encoding, chunk, hrtf, device, kernel=False)


def _shoebox(room_dims, source_pos, listener_pos, wall_log_beta, band_freqs, n_samples, max_order, sr, c, encoding,
             chunk, hrtf, device, kernel: bool) -> torch.Tensor:
    if hrtf is not None and not isinstance(hrtf, HRTFSet):
        raise TypeError(f"hrtf must be an HRTFSet (rir.hrtf), got {type(hrtf).__name__}")
    measured = encoding == "binaural" and hrtf is not None
    dev = source_pos.device if isinstance(source_pos, torch.Tensor) else resolve_device(device)
    with annotate("engine.ism", device=dev):
        f32 = dict(dtype=torch.float32, device=dev)
        room = torch.as_tensor(room_dims, **f32).reshape(3)
        src_all = torch.atleast_2d(torch.as_tensor(source_pos, **f32))
        lis = torch.atleast_2d(torch.as_tensor(listener_pos, **f32))
        if encoding != "omni":
            lis = lis[:1]
        e_total, n_rows = src_all.shape[0], lis.shape[0]
        c_out = encoding_channels(encoding, n_rows)
        n_samples = int(n_samples)
        n_freq = n_samples // 2 + 1

        n_np, q_np = _image_grid(int(max_order))
        count("host_syncs", 3)  # the grid's two uploads and `_band_to_bins`' read of the lowest band
        n_img = torch.as_tensor(n_np, device=dev)
        q_img = torch.as_tensor(q_np, device=dev)
        mirror = (1 - 2 * q_img).to(torch.float32)  # (K, 3)
        shift = (2.0 * n_img.to(torch.float32)) * room  # (K, 3)
        m0, m_l = (n_img - q_img).abs().to(torch.float32), n_img.abs().to(torch.float32)
        walls = torch.stack([m0[:, 0], m_l[:, 0], m0[:, 1], m_l[:, 1], m0[:, 2], m_l[:, 2]], dim=-1)  # (K, 6)

        f_idx = torch.arange(n_freq, dtype=torch.int32, device=dev)
        f_f32 = f_idx.to(torch.float32)
        freqs_hz = f_f32 * (sr / n_samples)
        interp = _band_to_bins(freqs_hz, torch.as_tensor(band_freqs, **f32).reshape(-1))
        log_beta_bins = _matmul_small(interp, torch.as_tensor(wall_log_beta, **f32).T)  # (F, 6)
        in_range = n_samples - (int(hrtf.hrirs.shape[-1]) if measured else 1)

        if kernel and dev.type != "cpu" and encoding in KERNEL_ENCODINGS:
            vec, dist, amp, d_frac, d_mod = image_terms(src_all, lis, mirror, shift, sr, c, in_range, n_samples)
            enc = (None if encoding in ("omni", "sh0")
                   else ambisonic_encoding_gains(image_directions(vec, dist), 3, encoding))  # (E, K, C_out)
            paths = n_rows * e_total
            count("ism.kernel")
            spec = shoebox_ism(d_mod.reshape(paths, -1), d_frac.reshape(paths, -1), amp.reshape(paths, -1), enc,
                               walls, log_beta_bins, n_samples).reshape(c_out, e_total, n_freq)
            return irfft_real(spec, n_samples).to(torch.float32)

        phase_scale = -2.0 * math.pi / n_samples
        if encoding == "binaural":
            w_ratio = (2.0 * math.pi * freqs_hz) * (HEAD_RADIUS_M / (2.0 * c))
            ear_phase = (-2.0 * math.pi) * freqs_hz

        k_total = walls.shape[0]
        e_blk, chunk = block_shape(n_rows, e_total, n_freq, k_total, "hrtf" if measured else encoding, chunk,
                                   CARD_LIVE_BYTES if dev.type == "cuda" else CPU_LIVE_BYTES)
        acc_re = torch.zeros((c_out, e_total, n_freq), **f32)
        acc_im = torch.zeros_like(acc_re)
        for e0 in range(0, e_total, e_blk):
            src = src_all[e0 : e0 + e_blk]
            for k0 in range(0, k_total, chunk):
                ks = slice(k0, k0 + chunk)
                gain = torch.exp(_matmul_small(walls[ks], log_beta_bins.T))  # (k, F)
                vec, dist, amp, d_frac, d_mod = image_terms(src, lis, mirror[ks], shift[ks], sr, c, in_range,
                                                            n_samples)  # (C, e, k)
                d_frac, d_mod = d_frac[..., None], d_mod[..., None]
                # (f * d) mod n in int32, as the reference splits it
                phase_i = (d_mod >> 8) * f_idx
                phase_i.remainder_(n_samples).bitwise_left_shift_(8).remainder_(n_samples)
                scratch = torch.mul(d_mod & 255, f_idx)
                phase_i.add_(scratch).remainder_(n_samples)
                phase = phase_i.to(torch.float32)
                del phase_i
                # scratch's storage, reused: f * d_frac, then cos, then the real part
                re = scratch.view(torch.float32)
                torch.mul(f_f32, d_frac, out=re)
                phase.add_(re).mul_(phase_scale)
                torch.cos(phase, out=re)
                im = phase.sin_()
                weight = amp[..., None] * gain  # (C, e, k, F)
                re.mul_(weight)
                im.mul_(weight)
                del weight
                es = slice(e0, e0 + src.shape[0])
                if encoding == "omni":
                    acc_re[:, es] += re.sum(dim=2)
                    acc_im[:, es] += im.sum(dim=2)
                    continue
                dirs = image_directions(vec, dist)  # (e, k, 3) receiver -> source
                re, im = re[0], im[0]
                if measured:
                    idx, wgt = hrtf.interp_weights(dirs)  # (e, k, 3)
                    for ear in range(2):  # one ear at a time bounds the (e, k, F) live set
                        h_t = torch.einsum("ekj,ekjn->ekn", wgt, hrtf.hrirs[idx][..., ear, :])
                        h = torch.fft.rfft(h_t, n=n_samples, dim=-1)  # (e, k, F)
                        del h_t
                        h_re, h_im = h.real, h.imag
                        acc_re[ear, es] += (re * h_re - im * h_im).sum(dim=1)
                        acc_im[ear, es] += (re * h_im + im * h_re).sum(dim=1)
                        del h, h_re, h_im
                elif encoding == "binaural":
                    itd = woodworth_itd(dirs, c=c)  # (e, k, 2)
                    for ear, cos_axis in enumerate((dirs[..., 1], -dirs[..., 1])):
                        mag = spherical_head_shadow(cos_axis, w_ratio)  # (e, k, F)
                        ph = ear_phase * itd[..., ear, None]
                        h_re, h_im = mag * torch.cos(ph), mag * torch.sin(ph)
                        del mag, ph
                        acc_re[ear, es] += (re * h_re - im * h_im).sum(dim=1)
                        acc_im[ear, es] += (re * h_im + im * h_re).sum(dim=1)
                else:
                    enc = ambisonic_encoding_gains(dirs, 3, encoding)  # (e, k, C_out)
                    acc_re[:, es] += torch.einsum("ekf,ekc->cef", re, enc)
                    acc_im[:, es] += torch.einsum("ekf,ekc->cef", im, enc)
        return irfft_real(torch.complex(acc_re, acc_im), n_samples).to(torch.float32)


def wall_log_betas_from_absorption(
    absorption, n_bands: int = 1, band_freqs: Optional[np.ndarray] = None
) -> tuple[np.ndarray, np.ndarray]:
    """(6, B) log reflection coefficients and the band centres, from a scalar
    absorption (all walls, all bands), a (6,) per-wall array or a (6, B)
    per-wall-per-band array; beta = sqrt(1 - alpha)."""
    absorption = np.asarray(absorption, dtype=np.float64)
    if absorption.ndim == 0:
        alpha = np.full((6, n_bands), float(absorption))
    elif absorption.ndim == 1:
        alpha = np.tile(absorption[:, None], (1, n_bands))
    else:
        alpha = absorption
        n_bands = alpha.shape[1]
    if band_freqs is None:
        band_freqs = np.geomspace(125.0, 8000.0, n_bands) if n_bands > 1 else np.array([1000.0])
    beta = np.sqrt(np.clip(1.0 - alpha, 1e-6, 1.0))
    return np.log(beta).astype(np.float32), np.asarray(band_freqs, dtype=np.float32)
