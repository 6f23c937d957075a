"""The scene render: plan packing, stems, placement, ambience, int16 WAV.

Counterpart of audiblelight_tpu/render.py. A scene is described by
fixed-shape tensors (`ScenePlan`, the reference's field layout, packed from
a Scene by `build_scene_plan`); events are rendered as a batch where the
reference vmaps. Stems are placed into the timeline on the device
(`place_stems_device`, the fused renderer) or, quantised, on the host
(`mix_stems_host`, the plan path).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.ops.convolve import fft_convolve, interpolation_matrix, tv_convolve
from audiblelight_tpu_torch.ops.noise import powerlaw_psd_gaussian
from audiblelight_tpu_torch.ops.scaling import normalize_irs
from audiblelight_tpu_torch.ops.stft import n_stft_frames

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
    wet = tv_convolve(audio, irs_n, w_ir)  # (C, samples)
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


def render_scene_arrays(
    static_audio, static_irs, static_mask, static_snr, static_start, static_len, static_place_len,
    moving_audio, moving_irs, moving_w, moving_mask, moving_snr, moving_start, moving_len, moving_place_len,
    ambience, ref_db, n_scene_samples: int,
) -> torch.Tensor:
    """One scene's (C, T) float mix from its plan tensors, on their device:
    the stems (`render_event_stems_arrays`) placed at their offsets, static
    events first, then the ambience bed (a (C, T) array or tensor, or None).
    Callers render a batch scene by scene (`parallel.render_batch`), so a
    scene's bits do not depend on the batch it rides in."""
    stems = render_event_stems_arrays(
        static_audio, static_irs, static_mask, static_snr, static_len, static_place_len,
        moving_audio, moving_irs, moving_w, moving_mask, moving_snr, moving_len, moving_place_len, ref_db,
    )
    mix = place_stems_device(stems, torch.cat([static_start, moving_start]), int(n_scene_samples))
    if ambience is None:
        return mix
    return mix + torch.as_tensor(ambience, dtype=torch.float32, device=mix.device)


def render_scene_plan(plan: ScenePlan) -> torch.Tensor:
    """Render a ScenePlan to its (C, T) float scene mix."""
    return render_scene_arrays(*(getattr(plan, f.name) for f in fields(ScenePlan)))


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


def mix_stems_host(stems_i16: np.ndarray, scales: np.ndarray, starts: np.ndarray, n_scene_samples: int,
                   ambience: Optional[np.ndarray] = None) -> np.ndarray:
    """Additive placement of quantised stems (E, C, S) int16 with per-stem
    scales (E,) at sample offsets (E,) into a (C, T) float32 scene mix, plus
    the host ambience bed. Events running past the scene end are clipped."""
    e, c, s = stems_i16.shape
    t = int(n_scene_samples)
    out = np.zeros((c, t), dtype=np.float32)
    for i in range(e):
        sc = float(scales[i])
        if sc == 0.0:
            continue
        start = int(starts[i])
        n = min(s, t - start)
        if n <= 0:
            continue
        out[:, start : start + n] += stems_i16[i, :, :n].astype(np.float32) * sc
    if ambience is not None:
        out += ambience
    return out


def _bucket(n: int, default: int = 1) -> int:
    """The next power of two at or above n (`default` for n <= 0)."""
    if n <= 0:
        return default
    p = 1
    while p < n:
        p *= 2
    return p


def build_scene_plan(scene, max_static: Optional[int] = None, max_moving: Optional[int] = None,
                     max_traj: Optional[int] = None, pad_audio_seconds: Optional[float] = None,
                     plan_path: bool = False, device: bool = True):
    """Pack a placed Scene into a fixed-shape ScenePlan on the scene's
    world-state device.

    Loads each event's audio on the host and pads the static / moving event
    slots, trajectory points and samples to the given buckets (next powers of
    two when not given), as the reference's build_scene_plan does.

    plan_path: the plan path's plan. Its IR banks come from the world
        state's trace (`trace_irs_device`, every microphone's channels
        stacked), or, for a world state that has no device trace (the
        shoebox), from its simulated `irs` (simulated first where there are
        none yet), and its (C, T) host ambience bed draws every ambience on
        the host (`Ambience.load_ambience`), scaled to its level and written
        into every microphone's channel span. False (the fused renderer's
        plan, which traces the IRs and draws the bed on the card) leaves
        zero-length IR placeholders and no bed.
    device: False returns the fused renderer's plan as host arrays, a dict
        of ScenePlan's fields (the scene-prep workers' form, which a batch
        uploads in one copy; `ScenePlan.from_numpy` puts it on a device).
    """
    sr = scene.sample_rate
    c_total = sum(int(m.n_channels) for m in scene.state.microphones.values())
    t = round(scene.duration * sr)
    all_irs = _plan_irs(scene.state) if plan_path else None

    statics, movings = [], []
    counter = 0
    for event in scene.events.values():
        audio = event.load_audio(normalize=True)
        start = max(0, round(event.scene_start * sr))
        end = min(round(event.scene_end * sr), t)
        entry = dict(audio=audio, n_em=len(event), first=counter, snr=float(event.snr), start=start,
                     length=len(audio), place_len=max(end - start, 0), duration=event.duration)
        counter += len(event)
        (movings if event.is_moving else statics).append(entry)

    es = max_static if max_static is not None else _bucket(len(statics))
    em = max_moving if max_moving is not None else _bucket(len(movings))
    if len(statics) > es or len(movings) > em:
        from audiblelight_tpu_torch.utils import logger

        logger.warning(f"Scene exceeds the plan's event buckets: keeping {es}/{len(statics)} static "
                       f"and {em}/{len(movings)} moving events")
    max_len = max([e["length"] for e in statics + movings] or [sr])
    s = round(pad_audio_seconds * sr) if pad_audio_seconds is not None else _bucket(max_len)
    j = max_traj if max_traj is not None else _bucket(max([e["n_em"] for e in movings] or [2]), default=2)
    fr = n_stft_frames(s)

    def slots(entries, n):
        audio = np.zeros((n, s), np.float32)
        fields = dict(mask=np.zeros(n, np.float32), snr=np.zeros(n, np.float32),
                      start=np.zeros(n, np.int32), len=np.ones(n, np.int32), place_len=np.zeros(n, np.int32))
        for i, e in enumerate(entries[:n]):
            m = min(e["length"], s)
            audio[i, :m] = e["audio"][:m]
            fields["mask"][i], fields["snr"][i], fields["start"][i] = 1.0, e["snr"], e["start"]
            fields["len"][i], fields["place_len"][i] = m, min(e["place_len"], s)
        return audio, fields

    static_audio, st = slots(statics, es)
    moving_audio, mv = slots(movings, em)
    moving_w = np.zeros((em, fr, j), np.float32)
    for i, e in enumerate(movings[:em]):
        n_j = min(e["n_em"], j)
        ir_times = np.linspace(0, e["duration"], e["n_em"])[:n_j]
        moving_w[i, :, :n_j] = interpolation_matrix(ir_times, sr, config.HOP_SIZE, fr)

    arrays = dict(
        static_audio=static_audio, static_irs=np.zeros((es, c_total, 0), np.float32),
        static_mask=st["mask"], static_snr=st["snr"], static_start=st["start"], static_len=st["len"],
        static_place_len=st["place_len"],
        moving_audio=moving_audio, moving_irs=np.zeros((em, c_total, j, 0), np.float32), moving_w=moving_w,
        moving_mask=mv["mask"], moving_snr=mv["snr"], moving_start=mv["start"], moving_len=mv["len"],
        moving_place_len=mv["place_len"],
        ambience=_host_ambience_bed(scene, c_total, t) if plan_path else None,
        ref_db=np.float32(scene.ref_db), n_scene_samples=t,
    )
    if not device and not plan_path:
        return arrays
    plan = ScenePlan.from_numpy(arrays, scene.state.device)
    if plan_path:
        plan.static_irs = torch.zeros((es, c_total, all_irs.shape[-1]), dtype=torch.float32, device=all_irs.device)
        for i, e in enumerate(statics[:es]):
            plan.static_irs[i] = all_irs[:, e["first"]]
        plan.moving_irs = torch.zeros((em, c_total, j, all_irs.shape[-1]), dtype=torch.float32,
                                      device=all_irs.device)
        for i, e in enumerate(movings[:em]):
            n_j = min(e["n_em"], j)
            plan.moving_irs[i, :, :n_j] = all_irs[:, e["first"] : e["first"] + n_j]
    return plan


def _plan_irs(state) -> torch.Tensor:
    """Every microphone's IR bank of a world state, stacked on its channel
    axis on the state's device: its device trace where it has one, else its
    simulated `irs`."""
    if hasattr(state, "trace_irs_device"):
        irs = state.trace_irs_device()
    else:
        try:
            irs = state.irs
        except AttributeError:
            state.simulate()
            irs = state.irs
    return torch.cat([torch.as_tensor(v, dtype=torch.float32, device=state.device) for v in irs.values()], dim=0)


def _host_ambience_bed(scene, c_total: int, t: int) -> np.ndarray:
    """The (C, T) float32 host bed: each ambience's normalised noise, scaled
    to 10^(ref_db / 20) / mean|noise| in float32 and written (the first) or
    added (the others) into every microphone's channel span, as the
    reference's build_scene_plan writes it."""
    ambience = np.zeros((c_total, t), dtype=np.float32)
    spans, off = [], 0
    for m in scene.state.microphones.values():
        spans.append((off, off + int(m.n_channels)))
        off += int(m.n_channels)
    for i_amb, amb in enumerate(scene.ambience.values()):
        noise = amb.load_ambience(normalize=True)
        scale = np.float32(10 ** (amb.ref_db / 20.0) / (np.mean(np.abs(noise)) + utils.tiny(noise)))
        for a, b in spans:
            rows = min(noise.shape[0], b - a)
            part = ambience[a : a + rows]
            if i_amb == 0:
                np.multiply(noise[:rows], scale, out=part, dtype=np.float32)
            else:
                part += noise[:rows].astype(np.float32) * scale
    return ambience
