"""The reference's audio stages, the same for every backend.

Given each emitter's impulse responses, a scene's payload is made so:

* an event's dry audio is its clip's first round(duration * sr) samples
  over their peak, in a slot of S samples (the plan's padded length);
* a response set (one emitter, every output channel) is divided by the
  mean of its channels' L2 norms;
* a static event's stem is the first S samples of the linear convolution
  of its dry audio with its emitter's responses;
* a moving event's stem is made in the STFT domain (sin^2 window of 256,
  hop 128, 512-point transforms, 128 samples of zeros in front,
  2 ceil(n / 256) + 1 frames): each frame of the dry audio is weighted
  towards the trajectory's points by a linear crossfade between the
  points' times, convolved along the frame axis with the spectrogram of
  each point's responses, summed over the points, and the frames added
  back at hops of 128 (no synthesis window) from sample 256 on; the
  stem stops at min(n, 2 ceil(n / 256) * 128 - 128) samples;
* the level: the stem cut to the dry audio's n samples is scaled so its
  mean |x| over channels and those samples is 10^((ref_db + snr) / 20),
  then cut to the samples the event has before the scene ends;
* each stem is stored as int16 of its peak (round half to even) and a
  scale, placed at its onset, and the ambience bed added;
* the bed is the Ambience API's gaussian noise: numpy's global stream,
  seeded per scene, draws one integer in [0, 2^31) that seeds a PCG64
  generator, which draws (channels, T) float32 standard normals; each
  channel is divided by its peak |x|, the whole scaled so its mean |x| is
  10^(ref_db / 20);
* the WAV holds the mix clipped to [-1, 1], times 32767, truncated.

Every stage runs in float64. `lowp` rounds each stage's output (the dry
audio, the crossfade weights, the responses, the stems, the bed, the mix):
the identity for the reference, bfloat16 for the control.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

HOP, WIN, NFFT = 128, 256, 512
F64 = torch.float64


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


def bfloat16(x: torch.Tensor) -> torch.Tensor:
    """`x` stored in bfloat16: the control's precision."""
    return x.to(torch.bfloat16).to(x.dtype)


def dry(clip: np.ndarray, duration: float, sr: int) -> np.ndarray:
    x = np.asarray(clip[: round(duration * sr)], dtype=np.float64)
    return x / np.max(np.abs(x))


def n_frames(n: int) -> int:
    return 2 * -(-n // (2 * HOP)) + 1


def stft(x: torch.Tensor) -> torch.Tensor:
    """(..., n) -> (..., frames, NFFT // 2 + 1)."""
    fr = n_frames(x.shape[-1])
    frames = F.pad(x, (WIN - HOP, fr * HOP - x.shape[-1])).unfold(-1, WIN, HOP)
    window = torch.sin(np.pi * torch.arange(WIN, dtype=F64, device=x.device) / WIN) ** 2
    return torch.fft.rfft(frames * window, n=NFFT)


def overlap_add(spec: torch.Tensor) -> torch.Tensor:
    """(..., frames, bins) -> (..., frames * HOP - WIN): each frame's
    unscaled inverse transform added at its hop, from sample WIN on."""
    fr = spec.shape[-2]
    frames = torch.fft.irfft(spec, n=NFFT) * NFFT
    out = torch.zeros(spec.shape[:-2] + ((fr - 1) * HOP + NFFT,), dtype=F64, device=spec.device)
    for i in range(fr):
        out[..., i * HOP : i * HOP + NFFT] += frames[..., i, :]
    return out[..., WIN : fr * HOP]


def crossfade(times: np.ndarray, sr: int, fr: int) -> np.ndarray:
    """(fr, J) weights of the trajectory's J points at each frame: point j
    sits at frame round((t_j sr + HOP) / HOP) - 1 (half to even), and the
    weight ramps linearly from one point's frame to the next one's."""
    at = np.round((np.asarray(times) * sr + HOP) / HOP).astype(int) - 1
    w = np.zeros((fr, len(at)))
    for j in range(len(at) - 1):
        span = np.arange(at[j], at[j + 1] + 1)
        ramp = np.linspace(0.0, 1.0, len(span))
        ok = (span >= 0) & (span < fr)
        w[span[ok], j] = 1.0 - ramp[ok]
        w[span[ok], j + 1] = ramp[ok]
    return w


def normalised(irs: torch.Tensor) -> torch.Tensor:
    """(..., C, L): each set over the mean of its channels' L2 norms."""
    return irs / torch.linalg.vector_norm(irs, dim=-1, keepdim=True).mean(dim=-2, keepdim=True)


def convolve(x: torch.Tensor, irs: torch.Tensor, s: int) -> torch.Tensor:
    """The first `s` samples of x (S,) convolved with irs (C, L)."""
    n = x.shape[-1] + irs.shape[-1] - 1
    return torch.fft.irfft(torch.fft.rfft(x, n=n) * torch.fft.rfft(irs, n=n), n=n)[..., :s]


def moving_wet(x: torch.Tensor, irs: torch.Tensor, w: torch.Tensor, s: int, n: int) -> torch.Tensor:
    """A moving event's stem before its level: x (S,) dry, irs (J, C, L)
    normalised, w (frames, J) crossfade -> (C, s)."""
    a = stft(x)  # (fr, K)
    h = stft(irs)  # (J, C, fr_h, K)
    fr, fr_h = a.shape[0], h.shape[-2]
    y = w.T[:, :, None] * a[None]  # (J, fr, K)
    m = fr_h + fr - 1
    out = torch.fft.ifft(
        (torch.fft.fft(h, n=m, dim=-2) * torch.fft.fft(y, n=m, dim=-2)[:, None]).sum(dim=0), dim=-2
    )[:, :fr]
    wet = overlap_add(out)  # (C, fr * HOP - WIN)
    wet = F.pad(wet, (0, max(0, s - wet.shape[-1])))[:, :s]
    wet[:, min(n, n_frames(n) * HOP - WIN) :] = 0.0
    return wet


def levelled(wet: torch.Tensor, n: int, place: int, snr: float, ref_db: float) -> torch.Tensor:
    wet = wet.clone()
    wet[:, n:] = 0.0
    wet = wet * (10.0 ** ((ref_db + snr) / 20.0) / (wet.abs().sum() / (wet.shape[0] * n)))
    wet[:, place:] = 0.0
    return wet


def gaussian_bed(seed: int, channels: int, t: int, ref_db: float) -> np.ndarray:
    inner = int(np.random.RandomState(seed).randint(0, 2**31))
    g = np.random.default_rng(inner).standard_normal((channels, t), dtype=np.float32).astype(np.float64)
    g /= np.max(np.abs(g), axis=1, keepdims=True)
    return g * (10.0 ** (ref_db / 20.0) / np.mean(np.abs(g)))


def payload(spec: dict, clips: list, irs_of: Callable, bed_seed: int, s: int, device,
            lowp: Callable = exact) -> np.ndarray:
    """The (C, T) int16 samples of one scene's WAV. `irs_of(event)` gives
    the event's (J, C, L) float64 responses (J = 1 for a static event) on
    `device`; `s` is the plan's padded event length in samples."""
    sr = int(spec["sample_rate"])
    t = round(spec["duration"] * sr)
    mix = None
    for ev in spec["events"]:
        x = dry(clips[ev["clip"]], ev["duration"], sr)
        n = min(len(x), s)
        x = lowp(torch.as_tensor(np.pad(x[:n], (0, s - n)), dtype=F64, device=device))
        irs = normalised(lowp(irs_of(ev)))
        start = max(0, round(ev["scene_start"] * sr))
        place = min(max(min(round((ev["scene_start"] + ev["duration"]) * sr), t) - start, 0), s)
        if ev["moving"]:
            times = np.linspace(0.0, ev["duration"], len(ev["trajectory"]))
            w = lowp(torch.as_tensor(crossfade(times, sr, n_frames(s)), dtype=F64, device=device))
            wet = moving_wet(x, irs, w, s, n)
        else:
            wet = convolve(x, irs[0], s)
        stem = lowp(levelled(wet, n, place, float(ev["snr"]), float(spec["ref_db"])))
        peak = stem.abs().max()
        if mix is None:
            mix = torch.zeros((stem.shape[0], t), dtype=F64, device=device)
        k = min(s, t - start)
        if peak > 0 and k > 0:
            q = torch.round(stem / peak * 32767.0)
            mix[:, start : start + k] += q[:, :k] * (peak / 32767.0)
    bed = lowp(torch.as_tensor(gaussian_bed(bed_seed, mix.shape[0], t, float(spec["ref_db"])), device=device))
    mix = lowp(mix + bed).cpu().numpy()
    return (np.clip(mix, -1.0, 1.0) * 32767.0).astype(np.int16)


def payload_gap(program: np.ndarray, reference: np.ndarray) -> int:
    """The widest gap, in int16 steps, between two payloads of one scene
    (a shape mismatch reads as the full scale)."""
    if program.shape != reference.shape:
        return 65535
    return int(np.max(np.abs(program.astype(np.int32) - reference.astype(np.int32))))
