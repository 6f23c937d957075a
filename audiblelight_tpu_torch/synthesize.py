"""DCASE metadata of a Scene (counterpart of audiblelight_tpu/synthesize.py's
generate_dcase2024_metadata), without pandas.

The rows are the reference frame's rows and `dcase_csv_text` writes the bytes
its `df.to_csv(sep=",", encoding="utf-8", header=None)` writes: the frame
number as the index column, then class, source, azimuth, elevation and
distance as integers, sorted stably by (frame, class, source).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

DCASE_2024_COLUMNS = [
    "frame_number",
    "active_class_index",
    "source_number_index",
    "azimuth",
    "elevation",
    "distance",
]


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
