"""Device half of the scene render: stems, placement, ambience, int16 WAV.

Counterpart of the device functions of audiblelight_tpu/render.py. A scene is
described by fixed-shape tensors (`ScenePlan`, the reference's field layout);
events are rendered as a batch where the reference vmaps.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from audiblelight_tpu_torch import config
from audiblelight_tpu_torch.ops.convolve import fft_convolve, time_variant_convolve_spec
from audiblelight_tpu_torch.ops.noise import powerlaw_psd_gaussian
from audiblelight_tpu_torch.ops.scaling import normalize_irs
from audiblelight_tpu_torch.ops.stft import istft_overlap_add, stft

_TINY = 1e-15


@dataclass
class ScenePlan:
    """Fixed-shape tensors describing one renderable scene.

    Es/Em = padded static/moving event counts, S = padded event samples,
    C = output channels, L = IR length, J = padded trajectory points,
    Fr = STFT frames for S, T = scene samples.
    """

    static_audio: torch.Tensor  # (Es, S)
    static_irs: torch.Tensor  # (Es, C, L)
    static_mask: torch.Tensor  # (Es,)
    static_snr: torch.Tensor  # (Es,)
    static_start: torch.Tensor  # (Es,) int32 sample offsets
    static_len: torch.Tensor  # (Es,) int32 true audio lengths
    static_place_len: torch.Tensor  # (Es,) int32 scene-slice lengths
    moving_audio: torch.Tensor  # (Em, S)
    moving_irs: torch.Tensor  # (Em, C, J, L)
    moving_w: torch.Tensor  # (Em, Fr, J)
    moving_mask: torch.Tensor  # (Em,)
    moving_snr: torch.Tensor  # (Em,)
    moving_start: torch.Tensor  # (Em,) int32
    moving_len: torch.Tensor  # (Em,) int32
    moving_place_len: torch.Tensor  # (Em,) int32
    ambience: Optional[np.ndarray]  # (C, T) host-side bed, or None
    ref_db: torch.Tensor  # () float32
    n_scene_samples: int

    @classmethod
    def from_numpy(cls, arrays: dict, device) -> "ScenePlan":
        """A plan on `device` from numpy fields (e.g. a reference plan's arrays).

        Integer fields become int64 (index arithmetic), float fields f32;
        `ambience` stays host-side and `n_scene_samples` an int.
        """
        out = {}
        for fld in fields(cls):
            v = arrays[fld.name]
            if fld.name == "n_scene_samples":
                out[fld.name] = int(v)
            elif fld.name == "ambience":
                out[fld.name] = None if v is None else np.asarray(v)
            else:
                a = np.array(v)
                dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
                out[fld.name] = torch.as_tensor(a, dtype=dtype, device=device)
        return cls(**out)


def _scale_event(wet, snr, ref_db, length, place_len):
    """Level chain for a batch of events (E, C, S): trim to the audio length,
    peak -> snr, mean -> ref_db + snr, trim to the scene-slice length."""
    s = wet.shape[-1]
    t = torch.arange(s, device=wet.device)
    wet = wet * (t[None] < length[:, None])[:, None, :]
    peak = torch.clamp_min(wet.abs().amax(dim=(1, 2)), _TINY)
    wet = wet * (snr / peak)[:, None, None]
    mean_abs = wet.abs().sum(dim=(1, 2)) / torch.clamp_min(wet.shape[1] * length, 1)
    scale = 10 ** ((ref_db + snr) / 20.0) / (mean_abs + _TINY)
    return wet * scale[:, None, None] * (t[None] < place_len[:, None])[:, None, :]


def _render_static_events(audio, irs, snr, ref_db, length, place_len, out_len):
    """Static events (Es, S) x IRs (Es, C, L) -> (Es, C, out_len) wet audio."""
    wet = fft_convolve(audio, normalize_irs(irs), out_len=out_len)
    return _scale_event(wet, snr, ref_db, length, place_len)


def _render_moving_event(audio, irs, w_ir, out_len, length):
    """One moving event (S,) x IRs (C, J, L) -> (C, out_len) via the STFT-domain
    time-variant convolution, before the level chain."""
    irs_n = normalize_irs(irs.transpose(0, 1)).transpose(0, 1)  # (C, J, L)
    spec = time_variant_convolve_spec(stft(audio), stft(irs_n), w_ir)
    wet = istft_overlap_add(spec).T  # (C, samples)
    if wet.shape[-1] < out_len:
        wet = F.pad(wet, (0, out_len - wet.shape[-1]))
    else:
        wet = wet[:, :out_len]
    # The reference iSTFT stops at n_frames(length) * hop - win and zero-pads
    # the rest of the event; reproduce that truncation.
    hop, win = config.HOP_SIZE, config.WIN_SIZE
    n_fr = 2 * torch.ceil(length / (2.0 * hop)).to(torch.int64) + 1
    tv_len = torch.minimum(length, n_fr * hop - win)
    return wet * (torch.arange(out_len, device=wet.device) < tv_len)[None, :]


def render_event_stems_arrays(
    static_audio, static_irs, static_mask, static_snr, static_len, static_place_len,
    moving_audio, moving_irs, moving_w, moving_mask, moving_snr, moving_len,
    moving_place_len, ref_db,
) -> torch.Tensor:
    """Per-event wet spatial stems for one scene: (Es+Em, C, S) float32."""
    s = static_audio.shape[-1]
    static_wet = _render_static_events(
        static_audio, static_irs, static_snr, ref_db, static_len, static_place_len, s
    ) * static_mask[:, None, None]
    em = moving_audio.shape[0]
    if em == 0:
        return static_wet
    moving_wet = torch.stack([
        _render_moving_event(moving_audio[i], moving_irs[i], moving_w[i], s, moving_len[i])
        for i in range(em)
    ])
    moving_wet = _scale_event(moving_wet, moving_snr, ref_db, moving_len, moving_place_len)
    return torch.cat([static_wet, moving_wet * moving_mask[:, None, None]], dim=0)


def quantize_stems(stems: torch.Tensor):
    """(..., E, C, S) stems -> (int16 stems, f32 per-stem scales (..., E)) with
    dequantised = q * scale. Rounds half to even, as jnp.round does."""
    peak = stems.abs().amax(dim=(-2, -1))
    safe = torch.clamp_min(peak, _TINY)
    q = torch.round(stems / safe[..., None, None] * 32767.0).to(torch.int16)
    scales = torch.where(peak > 0, safe / 32767.0, torch.zeros_like(safe)).to(torch.float32)
    return q, scales


def place_stems_device(stems: torch.Tensor, starts: torch.Tensor, t: int) -> torch.Tensor:
    """Additive placement of float stems (E, C, S) into a (C, t) timeline at
    per-event sample offsets; events running past the end are clipped.
    Offsets are clamped to [0, t], as the reference's dynamic_slice clamps."""
    e, c, s = stems.shape
    out = torch.zeros((c, t + s), dtype=torch.float32, device=stems.device)
    for i, start in enumerate(torch.as_tensor(starts).clamp(0, t).tolist()):
        out[:, start : start + s] += stems[i]
    return out[:, :t]


def ambience_bed_device(gen: torch.Generator, beta: float, ref_db: float, channels: int, t: int,
                        device) -> torch.Tensor:
    """A colored-noise ambience bed (channels, t) drawn on `device` from `gen`:
    per-channel peak normalisation, then 10^(ref_db/20) / mean|noise|.
    beta == 0 (white) skips the spectral shaping."""
    if float(beta) == 0.0:
        noise = torch.randn((channels, t), generator=gen, device=device)
    else:
        noise = powerlaw_psd_gaussian(gen, float(beta), (channels, t), device=device)
    peak = noise.abs().amax(dim=-1, keepdim=True)
    noise = noise / (peak + _TINY)
    scale = 10 ** (float(ref_db) / 20.0) / (noise.abs().mean() + _TINY)
    return (noise * scale).to(torch.float32)


def quantize_mix_wav(mix: torch.Tensor) -> torch.Tensor:
    """(C, T) float mix -> (C, T) int16 WAV samples: clip to [-1, 1], scale by
    32767, truncate toward zero (what an int16 WAV writer produces)."""
    return (torch.clamp(mix, -1.0, 1.0) * 32767.0).to(torch.int16)
