"""The classic per-event render and the DCASE metadata of a Scene
(counterpart of audiblelight_tpu/synthesize.py).

The classic render takes each event through its own convolution, as the
reference's `Scene.generate(compiled=False)` does: the event's audio
(loaded, augmented and peak-normalised), its IRs energy-normalised, a
static event convolved with its one IR (time-invariant), a moving one with
its trajectory's IRs crossfaded in the STFT domain (time-variant), then the
level chain (peak -> SNR, mean -> ref_db + SNR) and, for an event with
`ref_ir_channel` and `direct_path_time_ms`, its dry stem: the reference
channel's IR windowed around its peak, convolved with the dry audio. The
scene mix places every event (and the ambience) on the host.

The functions take and return numpy arrays, as the reference's do, and
compute in torch on the device of the IR bank they are given (a tensor), or
on `device` (default `cuda`) for a numpy bank. The reference pads lengths to
power-of-two buckets only to bound XLA recompiles; the port convolves the
true lengths, which gives the same sliced result.

The metadata rows are the reference frame's rows and `dcase_csv_text` writes
the bytes its `df.to_csv(sep=",", encoding="utf-8", header=None)` writes:
the frame number as the index column, then class, source, azimuth,
elevation and distance as integers, sorted stably by (frame, class,
source).

`generate_scene_video_from_events` writes the scene video: the room's
panorama from the first microphone through K1 on the state's device, the
events drawn per frame, as MP4 (H.264 where the shim builds, else MJPEG),
MJPEG AVI and GIF.
"""

from __future__ import annotations

from collections import Counter
from time import time
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from audiblelight_tpu_torch import config, utils
from audiblelight_tpu_torch.io.audio import valid_audio
from audiblelight_tpu_torch.ops import stft as _stft
from audiblelight_tpu_torch.ops.convolve import (
    fft_convolve,
    interpolation_matrix,
    time_variant_convolve_spec,
    tv_convolve,
)
from audiblelight_tpu_torch.ops.scaling import normalize_irs as _normalize_irs
from audiblelight_tpu_torch.utils import logger

if TYPE_CHECKING:  # pragma: no cover
    from audiblelight_tpu_torch.core import Scene
    from audiblelight_tpu_torch.event import Event

DCASE_2024_COLUMNS = [
    "frame_number",
    "active_class_index",
    "source_number_index",
    "azimuth",
    "elevation",
    "distance",
]


# ---------------------------------------------------------------------------
# Level helpers (host numpy, as the reference's)
# ---------------------------------------------------------------------------


def apply_snr(x: np.ndarray, snr: utils.Numeric) -> np.ndarray:
    """Scale a signal so its absolute peak equals `snr`."""
    return np.asarray(x) * snr / np.abs(x).max(initial=1e-15)


def db_to_multiplier(db: utils.Numeric, x: utils.Numeric) -> float:
    """Multiplier m such that 20*log10(m * x) ~= db."""
    return 10 ** (db / 20) / (x + utils.tiny(np.asarray(float(x), dtype=np.float32)))


def _device(x, device) -> torch.device:
    """The device a function computes on: a tensor input's own, else `device`."""
    return x.device if isinstance(x, torch.Tensor) else utils.resolve_device(device)


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def normalize_irs(irs, device=None) -> np.ndarray:
    """Energy-normalise an IR bank (see ops.scaling.normalize_irs)."""
    return _numpy(_normalize_irs(_tensor(irs, _device(irs, device))))


# ---------------------------------------------------------------------------
# Convolution paths (device compute)
# ---------------------------------------------------------------------------


def time_invariant_convolution(audio: np.ndarray, ir, device=None) -> np.ndarray:
    """Convolve mono audio (n_samples,) with a static multichannel IR
    (n_ir_samples, n_channels) -> (n_channels, n_samples + n_ir_samples - 1)."""
    if audio.ndim != 1:
        raise ValueError(f"Only mono input is supported, but got {audio.ndim} dimensions!")
    if ir.ndim != 2:
        raise ValueError(
            f"Expected shape of IR should be (n_samples, n_channels), but got ({ir.shape}) instead"
        )
    dev = _device(ir, device)
    return _numpy(fft_convolve(_tensor(audio, dev), _tensor(ir, dev).T))


def stft(
    y: np.ndarray,
    fft_size: Optional[int] = config.FFT_SIZE,
    win_size: Optional[int] = config.WIN_SIZE,
    hop_size: Optional[int] = config.HOP_SIZE,
    stft_dims_first: Optional[bool] = True,
    device=None,
) -> np.ndarray:
    """sin^2-window STFT (see ops.stft.stft); returns (frames, freq, ...)."""
    spec = _numpy(_stft.stft(_tensor(y, _device(y, device)), int(fft_size), int(win_size), int(hop_size)))
    if not stft_dims_first:
        spec = np.moveaxis(np.moveaxis(spec, 0, -1), 0, -2)
    return spec


def generate_interpolation_matrix(
    ir_times: np.ndarray,
    sr: utils.Numeric = config.SAMPLE_RATE,
    hop_size: utils.Numeric = config.HOP_SIZE,
    n_frames: Optional[utils.Numeric] = None,
) -> np.ndarray:
    """Linear IR crossfade weights (see ops.convolve.interpolation_matrix)."""
    return interpolation_matrix(ir_times, sr, int(hop_size), n_frames)


def perform_time_variant_convolution(
    s_audio: np.ndarray,
    s_ir: np.ndarray,
    w_ir: np.ndarray,
    ir_slice_min: utils.Numeric = 0,
    ir_relevant_ratio_max: utils.Numeric = 0.5,
    device=None,
) -> np.ndarray:
    """Convolve a time-varying IR spectrogram bank (frames, freq, ch, irs)
    with an audio spectrogram (frames, freq) under the weights (frames,
    irs). `ir_slice_min` and `ir_relevant_ratio_max` are accepted, as the
    reference accepts them, and unused: the frame-axis FFT needs no pruning."""
    dev = _device(s_ir, device)
    out = time_variant_convolve_spec(_tensor(s_audio, dev, torch.complex64), _tensor(s_ir, dev, torch.complex64),
                                     _tensor(w_ir, dev))
    return _numpy(out)


def istft_overlap_synthesis(
    spatial_stft: np.ndarray,
    fft_size: utils.Numeric = config.FFT_SIZE,
    win_size: utils.Numeric = config.WIN_SIZE,
    hop_size: utils.Numeric = config.HOP_SIZE,
    device=None,
) -> np.ndarray:
    """Overlap-add iSTFT (see ops.stft.istft_overlap_add)."""
    spec = _tensor(spatial_stft, _device(spatial_stft, device), torch.complex64)
    return _numpy(_stft.istft_overlap_add(spec, int(fft_size), int(win_size), int(hop_size)))


def _time_variant(irs: torch.Tensor, event: "Event", fft_size, win_size, hop_size) -> torch.Tensor:
    """The moving render of an event's (C, J, L) bank on its device."""
    audio = event.load_audio()
    hop_size = utils.sanitise_positive_number(hop_size, cast_to=int)
    win_size = utils.sanitise_positive_number(win_size, cast_to=int)
    ir_times = np.linspace(0, event.duration, len(event))
    w_ir = interpolation_matrix(ir_times, event.sample_rate, hop_size, _stft.n_stft_frames(audio.shape[-1], hop_size))
    return tv_convolve(_tensor(audio, irs.device), irs, w_ir, int(fft_size), win_size, hop_size)


def time_variant_convolution(
    irs,
    event: "Event",
    fft_size: Optional[utils.Numeric] = config.FFT_SIZE,
    win_size: Optional[utils.Numeric] = config.WIN_SIZE,
    hop_size: Optional[utils.Numeric] = config.HOP_SIZE,
    device=None,
) -> np.ndarray:
    """Moving-source render for an Event's IR bank (n_capsules, n_emitters,
    n_ir_samples): STFT -> TV conv -> iSTFT -> (n_channels, n_frames * hop - win)."""
    return _numpy(_time_variant(_tensor(irs, _device(irs, device)), event, fft_size, win_size, hop_size))


# ---------------------------------------------------------------------------
# Event / Scene rendering
# ---------------------------------------------------------------------------


def compute_dry_audio(event: "Event", irs, event_scale: float, mic_alias: str, device=None) -> None:
    """Compute and store the dry (direct-path + early-reflection) audio of an
    Event: the reference channel's IR zeroed outside `direct_path_time_ms`
    around its peak, convolved with the event's audio and scaled by
    `event_scale`. Needs both `ref_ir_channel` and `direct_path_time_ms`;
    skipped otherwise, with a warning when only one is set."""
    if event.ref_ir_channel is None and event.direct_path_time_ms is None:
        return
    if event.ref_ir_channel is not None and event.direct_path_time_ms is not None:
        ref_channel = event.ref_ir_channel
        if ref_channel >= irs.shape[0]:
            raise ValueError(
                f"Reference channel index out of range for IRs with {irs.shape[0]} channels"
            )
        low, high = event.direct_path_time_ms
        low_sp = int(low * event.sample_rate / 1000)
        high_sp = int(high * event.sample_rate / 1000)

        dev = _device(irs, device)
        ir_direct = _tensor(irs, dev)[ref_channel, 0, :].clone()
        peak = int(torch.argmax(ir_direct))
        if peak + high_sp < ir_direct.shape[0]:
            ir_direct[peak + high_sp :] = 0
        if peak - low_sp > 0:
            ir_direct[: peak - low_sp] = 0

        dry = _numpy(fft_convolve(_tensor(event.load_audio(ignore_cache=False), dev), ir_direct[None, :]))[0]
        event._spatial_audio_dry[mic_alias] = dry * event_scale
    else:
        logger.warning(
            "Only one of `ref_ir_channel` or `direct_path_time_ms` were specified when creating "
            "the Event. Dry audio will not be computed for this Event. Pass both variables to "
            "compute dry audio."
        )


def render_event_audio(
    event: "Event",
    irs,
    mic_alias: str,
    ref_db: utils.Numeric = config.DEFAULT_REF_DB,
    ignore_cache: Optional[bool] = True,
    fft_size: Optional[utils.Numeric] = config.FFT_SIZE,
    win_size: Optional[utils.Numeric] = config.WIN_SIZE,
    hop_size: Optional[utils.Numeric] = config.HOP_SIZE,
    device=None,
) -> None:
    """Render one Event's spatial audio at one microphone from its IRs
    (n_capsules, n_emitters, n_samples): the audio loaded, augmented and
    normalised; the IRs energy-normalised; a static event convolved
    time-invariantly, a moving one time-variantly, an event without IRs
    tiled over the channels; padded or trimmed to the audio's length, peak
    -> SNR, mean -> ref_db + SNR; stored on the Event with its dry stem."""
    if mic_alias in event.spatial_audio.keys() and not ignore_cache:
        return

    dev = _device(irs, device)
    irs_t = _tensor(irs, dev)
    n_ch, n_emitters, _ = irs_t.shape

    audio = event.load_audio(ignore_cache=ignore_cache, normalize=True)
    valid_audio(audio)
    n_audio_samples = audio.shape[0]

    # Per-event energy normalisation: (caps, src, samp) -> (src, caps, samp)
    irs_t = _normalize_irs(irs_t.transpose(0, 1)).transpose(0, 1)

    if n_emitters == 1:
        if event.is_moving:
            raise ValueError("Moving Event has only one emitter!")
        spatial = _numpy(fft_convolve(_tensor(audio, dev), irs_t[:, 0]))
    elif n_emitters == 0:
        logger.warning(
            f"No IRs were found for Event with alias {event.alias}. Audio is being tiled along "
            f"the channel dimension to match the expected shape {n_ch, n_audio_samples}."
        )
        spatial = np.repeat(audio[:, None], n_ch, 1).T
    else:
        if not event.is_moving:
            raise ValueError("Expected a moving event!")
        spatial = _numpy(_time_variant(irs_t, event, fft_size, win_size, hop_size))

    spatial = utils.pad_or_truncate_audio(spatial, n_audio_samples)
    spatial = apply_snr(spatial, event.snr)
    event_scale = db_to_multiplier(ref_db + event.snr, float(np.mean(np.abs(spatial))))
    spatial = event_scale * spatial

    utils.validate_shape(spatial.shape, (n_ch, n_audio_samples))
    valid_audio(spatial)
    event.spatial_audio[mic_alias] = spatial

    compute_dry_audio(event, irs_t, event_scale, mic_alias)


def render_audio_for_all_scene_events(scene: "Scene", ignore_cache: Optional[bool] = False) -> None:
    """Simulate the IRs (if needed) and render every (microphone, event)
    pair. Each microphone's bank goes to the world state's device once; an
    event's IRs are a slice of it there."""
    if ignore_cache:
        scene.state.simulate()
    else:
        try:
            _ = scene.state.irs
        except AttributeError:
            scene.state.simulate()

    validate_scene(scene)
    irs = scene.state.get_irs() if scene.state._irs is None else scene.state.irs

    start = time()
    for mic_alias, mic_ir in irs.items():
        mic_ir = _tensor(mic_ir, scene.state.device)
        emitter_counter = 0
        for event in scene.events.values():
            event_irs = mic_ir[:, emitter_counter : len(event) + emitter_counter, :]
            render_event_audio(event, event_irs, mic_alias=mic_alias, ref_db=scene.ref_db,
                               ignore_cache=ignore_cache)
            emitter_counter += len(event)

    logger.info(f"Rendered scene audio in {(time() - start):.2f} seconds!")


def generate_scene_audio_from_events(scene: "Scene") -> None:
    """Mix every event (and ambience) into per-microphone scene audio buffers,
    keeping each event's padded stem and padded dry stem."""
    from audiblelight_tpu_torch.ambience import Ambience

    for mic_alias in scene.state.microphones.keys():
        channels = max(ev.spatial_audio[mic_alias].shape[0] for ev in scene.events.values())
        duration = round(scene.duration * scene.sample_rate)
        scene_audio = np.zeros((channels, duration), dtype=np.float32)

        if len(scene.ambience) > 0:
            for ambience in scene.ambience.values():
                if not isinstance(ambience, Ambience):
                    raise TypeError(
                        f"Expected scene ambient noise to be of type Ambience, but got {type(ambience)}!"
                    )
                ambient_noise = ambience.load_ambience(normalize=True)
                if ambient_noise.shape != scene_audio.shape:
                    raise ValueError(
                        f"Scene ambient noise does not match expected shape. "
                        f"Expected {scene_audio.shape}, but got {ambient_noise.shape}."
                    )
                scaled = db_to_multiplier(ambience.ref_db, float(np.mean(np.abs(ambient_noise))))
                scene_audio += (scaled * ambient_noise).astype(np.float32)

        for event in scene.events.values():
            scene_start = max(0, round(event.scene_start * scene.sample_rate))
            scene_end = min(round(event.scene_end * scene.sample_rate), duration)
            if scene_end <= scene_start:
                logger.warning(f"Skipping event due to invalid slice: start={scene_start}, end={scene_end}")
                continue

            num_samples = scene_end - scene_start
            spatial_audio = utils.pad_or_truncate_audio(event.spatial_audio[mic_alias], num_samples)
            scene_audio[:, scene_start:scene_end] += spatial_audio.astype(np.float32)

            event_padded = np.zeros_like(scene_audio)
            event_padded[:, scene_start:scene_end] += spatial_audio.astype(np.float32)
            event._spatial_audio_padded[mic_alias] = event_padded

            if event._spatial_audio_dry.get(mic_alias) is not None:
                event_dry_padded = np.zeros(scene_audio.shape[1], dtype=scene_audio.dtype)
                dry_padded = utils.pad_or_truncate_audio(event._spatial_audio_dry[mic_alias][None, :], num_samples)[0]
                event_dry_padded[scene_start:scene_end] += dry_padded
                event._spatial_audio_dry_padded[mic_alias] = event_dry_padded

        valid_audio(scene_audio)
        utils.validate_shape(scene_audio.shape, (channels, duration))
        scene.audio[mic_alias] = scene_audio


def render_scene_classic(scene: "Scene") -> None:
    """The classic render of a whole scene: every event through its own
    convolution (the state's IR banks, simulated first where there are
    none), then the mix into `scene.audio`."""
    render_audio_for_all_scene_events(scene)
    generate_scene_audio_from_events(scene)


def validate_scene(scene: "Scene") -> None:
    """Validate a Scene before the classic render: emitters, microphones and
    events present, no orphaned event, and for a ray-traced room the engine
    context's listener and source counts."""
    if scene.state.num_emitters == 0:
        raise ValueError("WorldState has no emitters!")
    if len(scene.state.microphones) == 0:
        raise ValueError("WorldState has no microphones!")
    if len(scene.events) == 0:
        raise ValueError("Scene has no events!")

    total_ems = 0
    for alias, ev in scene.events.items():
        try:
            total_ems += len(ev)
        except ValueError:
            raise ValueError(f"Event with alias '{alias}' has no emitters registered. Has it been orphaned?")

    if not scene.state.name.upper() == "RLR":
        return

    if scene.state.ctx.get_listener_count() == 0:
        raise ValueError("Ray-tracing engine has no listeners!")
    if scene.state.ctx.get_source_count() == 0:
        raise ValueError("Ray-tracing engine has no sources!")

    vals = (total_ems, scene.state.num_emitters, scene.state.ctx.get_source_count())
    if not all(v == vals[0] for v in vals):
        raise ValueError(
            f"Mismatching number of emitters, events, and sources! "
            f"Got {len(scene.events)} events, {scene.state.num_emitters} emitters, "
            f"{scene.state.ctx.get_source_count()} sources. Have any been orphaned?"
        )

    capsules = sum(m.n_listeners for m in scene.state.microphones.values())
    if capsules != scene.state.ctx.get_listener_count():
        raise ValueError(
            f"Mismatching number of microphones and listeners! "
            f"Got {capsules} capsules, {scene.state.ctx.get_listener_count()} listeners. "
            f"Have any been orphaned?"
        )


# ---------------------------------------------------------------------------
# DCASE metadata
# ---------------------------------------------------------------------------


def generate_dcase2024_metadata(scene, temporal_resolution: float = 0.1) -> dict[str, list[list[int]]]:
    """Per-microphone DCASE-2024 SELD rows [frame (100 ms), class index,
    source index (per-class counters; repeated audio files share an ID),
    azimuth deg CCW, elevation deg, distance cm], sorted by (frame, class,
    source). Moving events interpolate their emitters' polar positions per
    frame. Frames without events have no row."""
    frames = np.round(np.arange(0, scene.duration + temporal_resolution, temporal_resolution), 1)
    microphones = list(scene.state.microphones.keys())
    res = {mic: [] for mic in microphones}

    unique_ids = Counter()
    seen_filepaths = {}
    for event in sorted(scene.get_events(), key=lambda e: e.scene_start):
        start_idx = np.where(frames == round(max(event.scene_start, 0.0), 1))[0][0]
        end_idx = np.where(frames == round(min(event.scene_end, scene.duration), 1))[0][0]
        event_range = np.arange(start_idx, end_idx + 1)

        if not isinstance(event.class_id, int):
            raise ValueError("Can't convert Event to DCASE format without valid DCASE class indices")

        if event.filename not in seen_filepaths:
            source_idx = unique_ids.get(event.class_id, 0)
            seen_filepaths[event.filename] = source_idx
            unique_ids[event.class_id] += 1
        else:
            source_idx = seen_filepaths[event.filename]

        for mic in microphones:
            if not event.is_moving:
                az, elv, dist = np.atleast_2d(event.emitters[0].coordinates_relative_polar[mic])[0]
                az, elv, dist = round(az), round(elv), round(dist * 100)
                res[mic].extend([[int(idx), event.class_id, source_idx, az, elv, dist] for idx in event_range])
            else:
                coords = np.vstack([np.atleast_2d(e.coordinates_relative_polar[mic]) for e in event.emitters])
                interp_times = frames[event_range]
                coord_times = np.linspace(min(interp_times), max(interp_times), num=len(coords))
                interpolated = np.stack(
                    [np.interp(interp_times, coord_times, coords[:, dim]) for dim in range(coords.shape[1])],
                    axis=1,
                )
                for idx, (az, elv, dist) in zip(event_range, interpolated):
                    res[mic].append([int(idx), event.class_id, source_idx, round(az), round(elv), round(dist * 100)])

    return {mic: sorted(rows, key=lambda r: (r[0], r[1], r[2])) for mic, rows in res.items()}


def dcase_csv_text(rows: list[list[int]]) -> str:
    """The DCASE CSV of one microphone's rows: one line per row, no header."""
    return "".join(",".join(str(int(v)) for v in row) + "\n" for row in rows)


# ---------------------------------------------------------------------------
# Video
# ---------------------------------------------------------------------------

VIDEO_SIZE = (640, 320)  # equirect frame (width, height), kept light for the GIF


def event_position(event, mic_alias: str, t: float) -> np.ndarray:
    """The event's (azimuth, elevation, distance) from microphone `mic_alias`
    at scene time `t`: its one emitter's, or linearly interpolated between
    the two emitters of its trajectory around t."""
    n_em = len(event.emitters)
    if n_em == 1:
        return np.atleast_2d(event.emitters[0].coordinates_relative_polar[mic_alias])[0]
    frac = (t - event.scene_start) / max(event.duration, 1e-9)
    fidx = frac * (n_em - 1)
    lo = int(np.floor(fidx))
    hi = min(lo + 1, n_em - 1)
    w = fidx - lo
    p_lo = np.atleast_2d(event.emitters[lo].coordinates_relative_polar[mic_alias])[0]
    p_hi = np.atleast_2d(event.emitters[hi].coordinates_relative_polar[mic_alias])[0]
    return (1 - w) * p_lo + w * p_hi


def scene_panorama(scene: "Scene") -> np.ndarray:
    """(320, 640, 3) uint8 panorama of the scene's room from the first
    microphone's centre: one first-hit launch (K1 big or small) of the
    pixel rays on the full mesh, on the world state's device, through the
    state's cached first-hit table. A failed launch raises (the reference
    draws a flat background instead)."""
    from audiblelight_tpu_torch.viz.panorama import render_equirect_panorama

    mic = scene.state.microphones[list(scene.state.microphones.keys())[0]]
    cam = np.atleast_2d(np.asarray(mic.coordinates_absolute)).mean(axis=0)
    st = scene.state.device_state
    width, height = VIDEO_SIZE
    return render_equirect_panorama(st.tris, cam, width, height, table=st.first_hit_table(st.tris),
                                    visuals=getattr(scene.state.mesh, "visuals", None))


def scene_video_frames(scene: "Scene", background, fps: int) -> list:
    """The video's frames (PIL Images): the background with each event active
    at the frame's time drawn at its equirect position, its image scaled
    with distance where it has one (a marker where the image does not load,
    as the reference draws), else a yellow marker."""
    from PIL import Image, ImageDraw

    width, height = VIDEO_SIZE
    n_frames = max(1, int(round(scene.duration * fps)))  # never zero frames
    mic_alias = list(scene.state.microphones.keys())[0]
    frames_out = []
    for frame_idx in range(n_frames):
        t = frame_idx / fps
        img = background.copy()
        draw = ImageDraw.Draw(img)
        for event in scene.get_events():
            if not (event.scene_start <= t <= event.scene_end):
                continue
            az, el, dist = event_position(event, mic_alias, t)
            # Equirect projection: az in [-180, 180) -> x, el in [-90, 90] -> y
            x = int((0.5 - az / 360.0) * width) % width
            y = int((0.5 - el / 180.0) * height)
            r = max(4, int(30 / max(dist, 0.5)))
            if event.image is not None or event.image_filepath is not None:
                try:
                    tile = Image.fromarray(event.load_image()).resize((4 * r, 4 * r))
                except (OSError, ValueError) as err:
                    logger.warning(f"Event image of {event.alias} not drawn ({err}); marker instead")
                else:
                    img.paste(tile, (x - 2 * r, y - 2 * r))
                    continue
            draw.ellipse([x - r, y - r, x + r, y + r], fill=(240, 200, 60))
        frames_out.append(img)
    return frames_out


def generate_scene_video_from_events(scene: "Scene", video_path, fps: Optional[int] = None) -> None:
    """Render an equirectangular animation of the scene's events.

    The background is the room's own panorama (`scene_panorama`: K1 on the
    world state's device), rendered once from the first microphone; each of
    `scene.duration * fps` 640 x 320 frames draws the events active at its
    time (`scene_video_frames`). Written as `<video_path>.mp4` (H.264 where
    the shim in io/h264.py builds, else MJPEG), `<video_path>.avi` (MJPEG)
    and `<video_path>.gif`. Only mesh-backed (rlr) scenes are supported, as
    in the reference; PIL is required (its ImportError otherwise).
    """
    if scene.state.name.upper() != "RLR":
        raise ValueError("Video generation is only supported for the RLR (mesh) backend")
    from pathlib import Path

    from PIL import Image

    from audiblelight_tpu_torch.io.avi import write_mjpeg_avi
    from audiblelight_tpu_torch.io.h264 import h264_available, write_h264_mp4
    from audiblelight_tpu_torch.io.mp4 import write_mjpeg_mp4

    fps = fps if fps is not None else scene.video_fps
    background = Image.fromarray(scene_panorama(scene))
    frames_out = scene_video_frames(scene, background, fps)

    mp4_path = Path(video_path).with_suffix(".mp4")
    out = write_h264_mp4(mp4_path, frames_out, fps) if h264_available() else write_mjpeg_mp4(mp4_path, frames_out,
                                                                                               fps)
    write_mjpeg_avi(Path(video_path).with_suffix(".avi"), frames_out, fps)
    gif = Path(video_path).with_suffix(".gif")
    frames_out[0].save(gif, save_all=True, append_images=frames_out[1:], duration=int(1000 / fps), loop=0)
    logger.info(f"Wrote scene video ({len(frames_out)} frames @ {fps} fps) to {out} (+ {gif.name})")
