"""The reference of the shoebox backend: a rectangular room [0, Lx] x
[0, Ly] x [0, Lz] whose six walls reflect a share beta = sqrt(1 - alpha)
of the pressure, the same at every frequency.

The responses follow Allen and Berkley's image sources. For every cell
n of the cube |n_x|, |n_y|, |n_z| <= order and every mirror parity
p in {0, 1}^3, the image of a source s is (1 - 2p) s + 2 n L; it has met
sum |n - p| + |n| walls, so it arrives with the amplitude
beta^walls / (4 pi max(d, 0.01)) after tau = d sr / c samples, d its
distance from the listener point. An image arriving at or after sample
N - 1 is left out. The response is the inverse real DFT (N points) of the
sum of the images' band-limited delays, amplitude * exp(-2 pi i f tau / N)
at each bin f = 0 .. N / 2, with each image's direction encoded: "omni"
one channel per listener point; "foa" the first listener point in AmbiX
order W, X, Y, Z with SN3D gains 1, x, y, z of the unit vector from the
listener to the image.

Computed in float64 on `device`; the audio stages are `reference.audio`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import audio

# Images a block of the sum over images takes at once
BLOCK = 2048


def images(order: int, device) -> tuple:
    """(cells n, parities p, walls met) of every image, (K, 3), (K, 3), (K,)."""
    r = torch.arange(-order, order + 1, device=device)
    n = torch.cartesian_prod(r, r, r)
    p = torch.cartesian_prod(*[torch.tensor([0, 1], device=device)] * 3)
    n, p = n.repeat_interleave(len(p), dim=0), p.repeat(len(n), 1)
    return n, p, (n - p).abs().sum(dim=1) + n.abs().sum(dim=1)


def responses(room, source, points, absorption: float, order: int, n_samples: int, sr: int, c: float,
              encoding: str, device) -> torch.Tensor:
    """(C, n_samples) float64 responses of one source at the rig's points."""
    f64 = dict(dtype=torch.float64, device=device)
    room = torch.as_tensor(room, **f64)
    cells, parity, walls = images(order, device)
    img = (1 - 2 * parity).to(torch.float64) * torch.as_tensor(source, **f64) + 2 * cells * room
    beta = math.sqrt(1.0 - absorption)
    bins = torch.arange(n_samples // 2 + 1, **f64)
    points = torch.as_tensor(np.atleast_2d(points), **f64)
    rows = [points[:1]] if encoding == "foa" else list(points[:, None])
    out = []
    for point in rows:
        v = img - point
        d = torch.linalg.vector_norm(v, dim=1)
        tau = d * (sr / c)
        amp = beta ** walls.to(torch.float64) / (4 * math.pi * d.clamp_min(0.01)) * (tau < n_samples - 1)
        gains = torch.cat([amp[:, None], amp[:, None] * v / d[:, None]], dim=1) if encoding == "foa" else amp[:, None]
        re = torch.zeros((gains.shape[1], len(bins)), **f64)
        im = torch.zeros_like(re)
        for k in range(0, len(d), BLOCK):
            phase = (2 * math.pi / n_samples) * tau[k : k + BLOCK, None] * bins
            re += gains[k : k + BLOCK].T @ torch.cos(phase)
            im -= gains[k : k + BLOCK].T @ torch.sin(phase)
        out.append(torch.fft.irfft(torch.complex(re, im), n=n_samples))
    return torch.cat(out)


def render(config: dict, spec: dict, clips: list, bed_seed: int, device, lowp=audio.exact) -> np.ndarray:
    """The (C, T) int16 payload of one shoebox scene."""
    eng, rig = config["engine"], config["rig"]
    sr = int(config["sample_rate"])
    points = np.asarray(spec["mic"]["position"]) + np.asarray(rig["capsules"], dtype=np.float64)

    def irs_of(ev):
        pts = ev["trajectory"] if ev["moving"] else [ev["position"]]
        return torch.stack([responses(spec["room"], p, points, float(eng["absorption"]), int(eng["max_order"]),
                                      round(float(eng["max_ir_length"]) * sr), sr, float(eng["speed_of_sound"]),
                                      rig["encoding"], device) for p in pts])

    s = round(float(config["pipeline"]["plan_kwargs"]["pad_audio_seconds"]) * sr)
    return audio.payload(spec, clips, irs_of, bed_seed, s, device, lowp)
