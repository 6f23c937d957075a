"""Equirectangular panorama of a room mesh, rendered by raycasting.

Counterpart of audiblelight_tpu/viz/panorama.py: one first-hit query per
pixel through the port's `geometry.queries.ray_mesh_first_hit` (on the card
one launch of K1, big or small by the mesh's face count; its plain version
on the CPU), shaded on the host exactly as the reference shades: a
headlight Lambertian term, a per-face albedo hashed for stable face
contrast (or the mesh's base-color textures where its `visuals` carry them)
and distance fog. The camera sits at the microphone, so the background
matches the equirect event overlay: az in [-180, 180) maps right-to-left
onto x, el in [-90, 90] top-to-bottom onto y (the convention of
synthesize.generate_scene_video_from_events). A failed launch raises.
"""

from __future__ import annotations

import numpy as np
import torch

from audiblelight_tpu_torch import utils


def _equirect_dirs(width: int, height: int) -> np.ndarray:
    """(H*W, 3) unit view directions for the pixel grid (x: az, y: el): pixel
    centres, the x axis running az = +180..-180 left to right."""
    az = (0.5 - (np.arange(width) + 0.5) / width) * 2.0 * np.pi
    el = (0.5 - (np.arange(height) + 0.5) / height) * np.pi
    azg, elg = np.meshgrid(az, el)  # (H, W)
    ce = np.cos(elg)
    dirs = np.stack([ce * np.cos(azg), ce * np.sin(azg), np.sin(elg)], axis=-1)
    return dirs.reshape(-1, 3).astype(np.float32)


def _sample_visuals(visuals, tris, fsafe, hit_points) -> tuple[np.ndarray, np.ndarray]:
    """Per-pixel albedo from the mesh's material layer (an io.gltf.MeshVisuals).

    Barycentric coordinates of each hit point in its face interpolate the
    face-corner UVs, which sample the base-color texture (nearest texel,
    REPEAT wrap: glTF's defaults). Untextured faces keep the base-color
    factor only. Returns (albedo (N, 3) float, textured (N,) bool).
    """
    a = tris[fsafe, 0]
    e1 = tris[fsafe, 1] - a
    e2 = tris[fsafe, 2] - a
    p = hit_points - a
    d11 = np.sum(e1 * e1, axis=-1)
    d12 = np.sum(e1 * e2, axis=-1)
    d22 = np.sum(e2 * e2, axis=-1)
    dp1 = np.sum(p * e1, axis=-1)
    dp2 = np.sum(p * e2, axis=-1)
    det = np.maximum(d11 * d22 - d12 * d12, 1e-20)
    u = np.clip((d22 * dp1 - d12 * dp2) / det, 0.0, 1.0)
    v = np.clip((d11 * dp2 - d12 * dp1) / det, 0.0, 1.0)
    w0 = np.clip(1.0 - u - v, 0.0, 1.0)

    uv_corners = visuals.face_uv[fsafe]  # (N, 3, 2)
    uv = (
        w0[:, None] * uv_corners[:, 0]
        + u[:, None] * uv_corners[:, 1]
        + v[:, None] * uv_corners[:, 2]
    )
    albedo = visuals.face_color[fsafe].astype(np.float32).copy()
    tex_idx = visuals.face_texture[fsafe]
    textured = tex_idx >= 0
    for ti, tex in enumerate(visuals.textures):
        sel = tex_idx == ti
        if not np.any(sel):
            continue
        h, w = tex.shape[:2]
        x = (np.mod(uv[sel, 0], 1.0) * (w - 1)).astype(np.int64)
        y = (np.mod(uv[sel, 1], 1.0) * (h - 1)).astype(np.int64)
        albedo[sel] *= tex[y, x].astype(np.float32) / 255.0
    return albedo, textured


def first_hits(tris, cam_pos, width: int, height: int, table=None, device=None) -> tuple:
    """The panorama's first hits: (t (H*W,), face (H*W,)) as numpy, from one
    `ray_mesh_first_hit` of the pixel rays on `device` (a tensor `tris`
    gives its own device; else default `cuda`, raising without a card).
    `table` is the mesh's `first_hit_table`, where the caller keeps one."""
    from audiblelight_tpu_torch.geometry.queries import ray_mesh_first_hit

    dev = tris.device if isinstance(tris, torch.Tensor) else utils.resolve_device(device)
    tris_t = torch.as_tensor(np.asarray(tris, dtype=np.float32), device=dev) if not isinstance(
        tris, torch.Tensor) else tris.to(torch.float32)
    cam = np.asarray(cam_pos, dtype=np.float32).reshape(3)
    dirs = _equirect_dirs(width, height)
    dirs_t = torch.as_tensor(dirs, device=dev)
    origins_t = torch.as_tensor(cam, device=dev).expand(dirs_t.shape[0], 3).contiguous()
    t, fidx = ray_mesh_first_hit(origins_t, dirs_t, tris_t, table)
    return t.cpu().numpy(), fidx.cpu().numpy()


def shade(tris: np.ndarray, cam_pos, width: int, height: int, t: np.ndarray, fidx: np.ndarray,
          fog_distance: float = 12.0, visuals=None) -> np.ndarray:
    """(H, W, 3) uint8 panorama from the first hits (host numpy, the
    reference's shading)."""
    tris = np.asarray(tris, dtype=np.float32)
    cam = np.asarray(cam_pos, dtype=np.float32).reshape(3)
    dirs = _equirect_dirs(width, height)

    hit = np.isfinite(t)
    fsafe = np.maximum(fidx, 0)

    n = np.cross(tris[fsafe, 1] - tris[fsafe, 0], tris[fsafe, 2] - tris[fsafe, 0])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    # Headlight: light rides the camera, so shading is |n . view|
    lam = np.abs(np.sum(n * dirs, axis=-1))
    shade_ = 0.25 + 0.75 * lam

    # Stable per-face albedo via an integer hash: adjacent scanned-mesh faces
    # get slightly different tones, which reads as surface texture
    h = (fsafe.astype(np.uint32) * np.uint32(2654435761)) >> np.uint32(16)
    jitter = 0.85 + 0.15 * ((h % np.uint32(256)).astype(np.float32) / 255.0)

    base = np.broadcast_to(np.array([0.78, 0.72, 0.62], np.float32), (len(fsafe), 3))  # warm interior tone
    mod = shade_ * jitter
    if visuals is not None:
        t_safe0 = np.where(hit, t, 0.0)
        hit_points = cam[None, :] + t_safe0[:, None] * dirs
        albedo, textured = _sample_visuals(visuals, tris, fsafe, hit_points)
        base = np.where(textured[:, None], albedo, base)
        # Textured pixels carry real surface colour: no hash jitter on them
        mod = np.where(textured, shade_, mod)

    t_safe = np.where(hit, t, 0.0)
    fog = np.exp(-t_safe / fog_distance).astype(np.float32)
    sky = np.array([0.06, 0.07, 0.10], np.float32)

    rgb = base * (mod * fog)[:, None]
    rgb = np.where(hit[:, None], rgb, sky[None, :])
    return np.clip(rgb.reshape(height, width, 3) * 255.0, 0, 255).astype(np.uint8)


def render_equirect_panorama(
    tris,
    cam_pos,
    width: int = 640,
    height: int = 320,
    fog_distance: float = 12.0,
    table=None,
    visuals=None,
    device=None,
) -> np.ndarray:
    """(H, W, 3) uint8 panorama of the mesh `tris` (F, 3, 3) seen from `cam_pos`.

    Escaped rays (mesh holes) render as dark sky. With `visuals` (an
    io.gltf.MeshVisuals, e.g. `mesh.visuals` of a textured GLB) pixels
    sample the mesh's base-color textures at the hit UVs; without, shading
    is geometry only. The first hits run on `device` (a tensor `tris` gives
    its own; default `cuda`, raising without a card) through `table`, the
    mesh's `first_hit_table` where the caller keeps one.
    """
    t, fidx = first_hits(tris, cam_pos, width, height, table=table, device=device)
    tris_np = tris.cpu().numpy() if isinstance(tris, torch.Tensor) else tris
    return shade(tris_np, cam_pos, width, height, t, fidx, fog_distance=fog_distance, visuals=visuals)


__all__ = ["render_equirect_panorama", "first_hits", "shade"]
