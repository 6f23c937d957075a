"""Stochastic acoustic ray tracer over triangle meshes (PyTorch, wavefront-style).

Counterpart of the main-path functions of audiblelight_tpu/rir/raytracer.py,
for omni capsule rigs ("omni": AmbeoVR and other "mic" layouts) and the
one-point listeners: first-order ambisonics ("foa": AmbiX [W, X, Y, Z]),
higher orders ("sh2", "sh3": ACN/SN3D) and the binaural head ("binaural":
[left, right]; the analytic spherical head, or a measured HRTF set,
rir.hrtf):

  1. E sources x N rays leave the sources with unit-total energy per source.
  2. Each bounce: first hit against the mesh (K1, or one of the reference's
     two optional routes: the classic Moller-Trumbore K7 on the face tree
     of a big full mesh, the bilinear K8 on an acoustic LOD), per-band
     absorption, a diffuse-rain deposit toward the listener, binned by
     arrival time, and a specular-or-Lambertian reflection chosen by the
     surface scattering.
     The deposit is fused with its histogram fold for omni capsules (K3)
     and for FOA with a first-order tail (K4); the other encodings run the
     reference's unfused chain (arrival direction, gains, bins) folded by
     the grouped histogram (K5). Rain visibility comes from the per-face
     table that K2 filled (one gather), or, in the exact mode, from one
     query per hit point: the star any-hit (K6) where a star layout was
     built, else the dense any-hit (K2).
  3. The IRs are synthesised from the histograms with band-filtered noise
     carriers, plus the exact direct path and knife-edge diffraction, both
     encoded at the listener for the one-point rigs.

The bounce loop is a Python loop with the reference's early exit: it stops
when every ray is dead, which costs one host read of a flag per bounce. It
traces B scenes of one room at once where the reference vmaps its fused
program (`trace_rirs_batch`): their rays in one wavefront, each kernel
launched once per bounce for the batch, each scene drawing from its own
generator and stopping when its own rays are dead (a (B,) flag read per
bounce), so that each scene gets its one-scene bits.
Random numbers come from an explicit torch.Generator; they are not the
reference's threefry draws, so the stochastic tail agrees statistically.
Where the reference branches on the TPU, this follows its CPU branch: the
exact-length carrier FFT and the gather envelope upsample. The optional
first-hit routes are the exception: the reference takes them on a TPU only,
the port wherever config.USE_TILED_FIRST_HIT or config.USE_MXU_FIRST_HIT
selects them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from audiblelight_tpu_torch import config
from audiblelight_tpu_torch.geometry.queries import ray_mesh_first_hit, segments_occluded
from audiblelight_tpu_torch.ops.cuda_kernels import (
    bin_histogram,
    deposit_histogram,
    deposit_histogram_foa,
    first_hit_table,
)
from audiblelight_tpu_torch.ops.mxu_first_hit import MXU_F_MAX, build_mxu_face_tables, mxu_first_hit
from audiblelight_tpu_torch.ops.star_occlusion import star_segments_occluded
from audiblelight_tpu_torch.ops.tiled_first_hit import tiled_first_hit
from audiblelight_tpu_torch.rir.sh import (
    ambisonic_encoding_gains,
    encoding_channels,
    spherical_head_gains,
    woodworth_itd,
)
from audiblelight_tpu_torch.utils import cross3, dot3, irfft_real, norm3


def _check_encoding(encoding: str, cl: int) -> None:
    """The encodings this port traces: omni capsules, and one listener point
    encoded as FOA, higher-order ambisonics or the analytic binaural head."""
    if encoding == "omni":
        return
    if (encoding in ("foa", "binaural") or encoding.startswith("sh")) and cl == 1:
        return
    raise NotImplementedError(
        f"encoding {encoding!r} at {cl} listener points is not ported: the one-point rigs trace one point"
    )


def _band_centers(n_bands: int, device) -> torch.Tensor:
    """The tracer's band centre frequencies (Hz), f32."""
    f = np.geomspace(125.0, 8000.0, n_bands) if n_bands > 1 else np.array([1000.0])
    return torch.as_tensor(f, dtype=torch.float32, device=device)


def _sphere_directions(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """n uniformly distributed unit vectors."""
    v = torch.randn((n, 3), generator=gen, device=device)
    return v / norm3(v, keepdim=True)


def _helper_axis(v: torch.Tensor) -> torch.Tensor:
    """Per row of (R, 3) unit vectors, the x axis where |v_x| < 0.9, else the
    y axis: never close to parallel to v. Built on v's device (a constant
    copied from the host would stall the stream)."""
    use_x = (v[:, 0].abs() < 0.9).to(v.dtype)
    return torch.stack([use_x, 1.0 - use_x, torch.zeros_like(use_x)], dim=-1)


def _hemisphere_local(gen: torch.Generator, r: int, device) -> torch.Tensor:
    """(r, 3) cosine-weighted directions about +z, drawn from `gen`."""
    u1 = torch.rand(r, generator=gen, device=device)
    u2 = torch.rand(r, generator=gen, device=device)
    rad = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    return torch.stack([rad * torch.cos(phi), rad * torch.sin(phi), torch.sqrt(1.0 - u1)], dim=-1)


def _cosine_hemisphere(draws: "_SceneDraws", normals: torch.Tensor) -> torch.Tensor:
    """Cosine-weighted directions about each (R, 3) normal, each scene's
    drawn from its own generator."""
    local = draws.each(lambda g, r: _hemisphere_local(g, r, normals.device), (3,))
    t1 = cross3(normals, _helper_axis(normals))
    t1 = t1 / torch.clamp_min(norm3(t1, keepdim=True), 1e-12)
    t2 = cross3(normals, t1)
    return local[:, 0:1] * t1 + local[:, 1:2] * t2 + local[:, 2:3] * normals


class _SceneDraws:
    """The random draws of a bounce for B scenes traced together, each from
    its own generator in the one-scene order and sizes (the scenes' rays
    are scene-major, `per_scene` rows each). A scene whose rays are all dead
    draws nothing, as the one-scene loop stops drawing once it exits, so its
    generator stays where its one-scene trace leaves it; its rows get zeros.
    Transcendentals run on each scene's own draw (`_hemisphere_local`), so
    the CPU's vector loops split them as in a one-scene trace."""

    def __init__(self, gens: list, live: list, per_scene: int, device):
        self.gens, self.live, self.per_scene, self.device = gens, live, per_scene, device

    def each(self, draw, tail: tuple = ()) -> torch.Tensor:
        """`draw(gen, rows)` of every live scene, concatenated."""
        parts = [draw(g, self.per_scene) if ok else
                 torch.zeros((self.per_scene, *tail), dtype=torch.float32, device=self.device)
                 for g, ok in zip(self.gens, self.live)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def rand(self) -> torch.Tensor:
        return self.each(lambda g, r: torch.rand(r, generator=g, device=self.device))


def transmission_generators(gens: list) -> list:
    """The transmission roulette's generator of each scene: on its scene
    generator's device, seeded from that generator's seed, so a trace with
    transmission keeps every other draw of the trace without it."""
    out = []
    for g in gens:
        seed = np.random.SeedSequence([g.initial_seed(), 0x7472616E]).generate_state(1, np.uint64)[0]
        out.append(torch.Generator(device=g.device).manual_seed(int(seed >> np.uint64(1))))
    return out


def decimation_phases(n_rays: int, max_depth: int, enabled: bool) -> tuple:
    """(start_bounce, end_bounce, rays_per_source) schedule of the progressive
    wavefront decimation: at depth/3 and 2*depth/3 each source keeps the first
    half of its rays with doubled energy (an unbiased Russian-roulette
    thinning). Short or thin traces run one phase."""
    if not enabled or max_depth < 24 or n_rays < 2048:
        return ((0, max_depth, n_rays),)
    b1, b2 = max_depth // 3, (2 * max_depth) // 3
    return ((0, b1, n_rays), (b1, b2, n_rays // 2), (b2, max_depth, n_rays // 4))


def _halve_wavefront(state: tuple, n_sources: int, r_now: int, r_next: int) -> tuple:
    """Keep each source's first r_next rays, scaling energy by r_now/r_next."""
    origins, dirs, energy, dist, alive, prev_face = state

    def keep(x):
        return x.reshape((n_sources, r_now) + x.shape[1:])[:, :r_next].reshape(
            (n_sources * r_next,) + x.shape[1:]
        )

    boost = float(np.float32(r_now / r_next))
    return keep(origins), keep(dirs), keep(energy) * boost, keep(dist), keep(alive), keep(prev_face)


def _mxu_tables_for(tris: torch.Tensor, tiled_tree, tables=None):
    """The K8 face tables of `tris`, or None where that route does not apply:
    the flag is off, K7's tree was given, or the mesh has more than
    MXU_F_MAX faces. The reference's conditions less its TPU test: the port
    takes the route on every device. `tables` are the ones the caller keeps
    per mesh (`MeshDeviceState.mxu_tables`); without them they are built
    here, once per trace."""
    if config.USE_MXU_FIRST_HIT and tiled_tree is None and tris.shape[0] <= MXU_F_MAX:
        return build_mxu_face_tables(tris) if tables is None else tables
    return None


def _first_hit_route(origins, dirs, prev_face, tris, route):
    """The bounce's first hit: K7 where its tree was given, else K8 where
    its tables were built, else the dense kernel (K1), in the reference's
    order. `route` = (first-hit table, tiled_tree, mxu_tables)."""
    table, tiled_tree, mxu_tables = route
    if tiled_tree is not None:
        return tiled_first_hit(tiled_tree, origins, dirs)
    if mxu_tables is not None:
        return mxu_first_hit(mxu_tables, origins, dirs, prev_face)
    return ray_mesh_first_hit(origins, dirs, tris, table)


def _rain_occlusion(hit, normal, face_safe, listener_pos, tris, vis) -> torch.Tensor:
    """(C, TR) bool rain visibility of one bounce's hit points, True where
    the listener point does not see the hit.

    `vis` = (face_occlusion, star, occlusion, shared_visibility, tree,
    scene_faces): a per-face table is one gather by hit face (for a batch
    of scenes, the (P, B * F) tables side by side, gathered at
    `scene_faces(face_safe)`, each ray's face in its scene's table); else,
    in the exact mode (one scene), each
    hit point (moved 1e-4 off the surface) is queried toward the rig's
    centroid (shared visibility) or toward every listener point, through the
    star any-hit where a layout `star` was built and through the any-hit on
    `tris` (its any-hit tree `tree`) where it was not (`occlusion`); a
    convex room is never blocked."""
    face_occlusion, star, occlusion, shared, tree, scene_faces = vis
    cl, tr = listener_pos.shape[-2], hit.shape[0]
    if face_occlusion is not None:
        return face_occlusion[:, scene_faces(face_safe)].expand(cl, tr)
    if star is None and not occlusion:
        return torch.zeros((cl, tr), dtype=torch.bool, device=hit.device)
    starts = (hit + 1e-4 * normal).contiguous()
    if star is not None and shared:
        return star_segments_occluded(star, starts, listener_pos.mean(dim=0))[None].expand(cl, tr)
    if star is not None:
        return torch.stack([star_segments_occluded(star, starts, listener_pos[i]) for i in range(cl)])
    if shared and cl > 1:
        center = listener_pos.mean(dim=0)
        return segments_occluded(starts, center.expand(tr, 3), tris, tree)[None].expand(cl, tr)
    ends = listener_pos.repeat_interleave(tr, dim=0)
    return segments_occluded(starts.repeat(cl, 1), ends, tris, tree).reshape(cl, tr)


def _unfused_deposit(hit, normal, e_refl, new_dist, hit_ok, occ, listener_pos, n_sources, n_bins, bin_dt,
                     c, encoding, sh_order, band_freqs, hrtf=None, hrtf_bp=None):
    """The reference's unfused deposit chain for one listener point, folded
    by the grouped histogram (K5): (E, C_out, B, n_bins). `listener_pos` is
    (1, 3), or (B, 1, 3) for B scenes traced together: each ray then takes
    its scene's point, and K5's inputs are per ray already.

    The deposit e_refl cos(theta) / (4 pi^2 max(d, 1e-2)^2), masked by
    visibility and range, is weighted by the gains of the arrival direction:
    the ambisonic gains at `sh_order`, or for "binaural" the per-band power
    gains |H_ear|^2 of the spherical head, or of the measured set `hrtf`
    blended from its band-power table `hrtf_bp` (`HRTFSet.band_powers`)."""
    tr, n_bands = e_refl.shape
    if listener_pos.dim() == 3:  # each ray's scene's point
        listener_pos = listener_pos[torch.arange(tr, device=hit.device) // (tr // listener_pos.shape[0])]
        vec = listener_pos.transpose(0, 1) - hit[None]
    else:
        vec = listener_pos[:, None, :] - hit[None]
    d_l = norm3(vec)
    dir_l = vec / torch.clamp_min(d_l[..., None], 1e-9)
    cos_th = torch.clamp_min(dot3(dir_l, normal[None]), 0.0)
    visible = hit_ok[None] & ~occ & (cos_th > 0)
    m = torch.clamp_min(d_l, 1e-2)
    deposit = e_refl[None] * (cos_th / ((4.0 * math.pi**2) * (m * m)))[..., None] * visible[..., None]
    arrival = (new_dist[None] + d_l) / c
    bin_idx = torch.clamp((arrival / bin_dt).to(torch.int32), 0, n_bins - 1)
    deposit = deposit * (arrival < n_bins * bin_dt)[..., None]
    if encoding == "binaural":
        if hrtf_bp is not None:
            gains = hrtf.band_power_at(-dir_l[0], hrtf_bp)  # (TR, 2, B)
        else:
            gains = spherical_head_gains(-dir_l[0], band_freqs) ** 2  # (TR, 2, B)
        weighted = deposit[0][:, None, :] * gains
    else:
        gains = ambisonic_encoding_gains(-dir_l[0], sh_order, encoding)  # (TR, C_out)
        weighted = deposit[0][:, None, :] * gains[:, :, None]
    c_out = weighted.shape[1]
    r_src = tr // n_sources
    add = bin_histogram(bin_idx[0].reshape(n_sources, r_src),
                        weighted.reshape(n_sources, r_src, c_out * n_bands).contiguous(), n_bins)
    return add.reshape(n_sources, n_bins, c_out, n_bands).permute(0, 2, 3, 1)


def _bounce(draws, state, tris, route, tri_normals, face_absorption, face_scattering, vis,
            listener_pos, n_sources, n_rays, n_bins, bin_dt, c, encoding, sh_order, band_freqs,
            hrtf=None, hrtf_bp=None, trans=None):
    """One bounce of the whole wavefront: (new state, histogram increment).
    `draws` (`_SceneDraws`) holds each scene's generator; `route` selects
    the first hit (`_first_hit_route`); `vis` holds the rain-visibility
    inputs of `_rain_occlusion`; `listener_pos` is (C, 3), or (B, C, 3) for
    B scenes (each kernel launches once for all of them); `hrtf`, `hrtf_bp`
    a measured binaural set and its band-power table.

    `trans` = (face transmission (F, B), `_SceneDraws` of the transmission
    generators) turns transmission on: the non-absorbed energy splits into
    a reflected part (1 - tau), which the rain deposits, and a transmitted
    part (tau); a Russian roulette with p_t the transmitted share of the
    band-mean energies sends the ray through the face (direction kept,
    origin 1e-4 behind the face) or reflects it, the branch's energy divided
    by its probability. Its uniform comes from generators of its own, so
    tau = 0 gives the bits of a trace without transmission."""
    origins, dirs, energy, dist, alive, prev_face = state
    tr = origins.shape[0]

    t, face = _first_hit_route(origins, dirs, prev_face, tris, route)
    finite = torch.isfinite(t)
    hit_ok = alive & finite
    t_safe = torch.where(finite, t, torch.zeros_like(t))
    face_safe = torch.clamp_min(face, 0).long()
    hit = origins + t_safe[:, None] * dirs
    new_dist = dist + t_safe

    normal = tri_normals[face_safe]
    normal = torch.where((dot3(normal, dirs) > 0)[:, None], -normal, normal)
    e_refl = energy * (1.0 - face_absorption[face_safe])
    if trans is not None:
        tau = trans[0][face_safe]
        e_refl, e_trans = e_refl * (1.0 - tau), e_refl * tau

    occ = _rain_occlusion(hit, normal, face_safe, listener_pos, tris, vis)
    if encoding == "omni" or (encoding == "foa" and sh_order == 1):
        deposit = deposit_histogram if encoding == "omni" else deposit_histogram_foa
        add = deposit(
            hit.contiguous(), normal.contiguous(), e_refl.contiguous(), new_dist.contiguous(),
            (occ | ~hit_ok[None]).contiguous(), listener_pos,
            n_sources=n_sources, n_bins=n_bins, bin_dt=bin_dt, c_sound=c,
        )
    else:
        add = _unfused_deposit(hit, normal, e_refl, new_dist, hit_ok, occ, listener_pos, n_sources, n_bins,
                               bin_dt, c, encoding, sh_order, band_freqs, hrtf, hrtf_bp)

    spec_dir = dirs - (2.0 * dot3(dirs, normal))[:, None] * normal
    diff_dir = _cosine_hemisphere(draws, normal)
    go_diffuse = draws.rand() < face_scattering[face_safe]
    new_dirs = torch.where(go_diffuse[:, None], diff_dir, spec_dir)
    new_origins = hit + 1e-4 * normal
    new_energy = e_refl
    if trans is not None:
        p_t = e_trans.mean(dim=-1) / torch.clamp_min(e_refl.mean(dim=-1) + e_trans.mean(dim=-1), 1e-30)
        go_trans = (trans[1].rand() < p_t)[:, None]
        new_energy = torch.where(go_trans, e_trans / torch.clamp_min(p_t, 1e-12)[:, None],
                                 e_refl / torch.clamp_min(1.0 - p_t, 1e-12)[:, None])
        new_dirs = torch.where(go_trans, dirs, new_dirs)
        new_origins = hit + torch.where(go_trans, -1e-4, 1e-4) * normal
    new_alive = (
        hit_ok
        & (new_energy.amax(dim=-1) * n_rays > 1e-6)
        & (new_dist < c * n_bins * bin_dt)
    )
    # The next bounce masks the face just hit (K8's self-mask); -1 on a miss
    new_prev = torch.where(hit_ok, face, torch.full_like(face, -1))
    return (new_origins, new_dirs, new_energy, new_dist, new_alive, new_prev), add


def trace_energy_histogram_multi(
    gen: torch.Generator,
    tris: torch.Tensor,
    face_absorption: torch.Tensor,
    face_scattering: torch.Tensor,
    source_positions: torch.Tensor,
    listener_pos: torch.Tensor,
    n_rays: int = 2000,
    max_depth: int = 50,
    n_bins: int = 512,
    bin_dt: float = 0.002,
    c: float = config.SPEED_OF_SOUND,
    *,
    face_occlusion: torch.Tensor = None,
    **kw,
) -> torch.Tensor:
    """Energy histograms for E sources traced together in one wavefront.

    Arguments:
        tris: (F, 3, 3) triangles; face_absorption (F, B); face_scattering (F,).
        source_positions: (E, 3); listener_pos: (C, 3) omni capsules, or
            (1, 3) the one listener point of the other encodings.
        face_occlusion: (1 or C, F) bool rain-visibility table (True =
            blocked), the "face" rain mode.
        star: an `ops.star_occlusion.StarAccel` of `tris` about the rig's
            centroid: the "exact" rain mode through the star any-hit.
        occlusion: without a table or a star, True queries each hit point
            through the dense any-hit (the exact mode where no star layout
            pays); False is a convex room, never blocked.
        shared_visibility: the exact mode queries the rig's centroid once
            per hit point (True) or every listener point.
        decimate: progressive wavefront decimation (see decimation_phases).
        encoding, sh_order: "omni", "foa", "sh2", "sh3" or "binaural"; the
            ambisonic tail encodes at `sh_order`, clipped to the layout's.
        tiled_tree: K7's face tree of `tris` (`ops.tiled_first_hit.
            build_tiled_tree`; the reference's `mesh_tiles`): the bounce
            first hit runs K7 on it. Without it, `config.USE_MXU_FIRST_HIT`
            runs K8 on a mesh of at most MXU_F_MAX faces; else K1.
        fh_table: K1's `first_hit_table(tris)` where the caller keeps it
            (built here when None).
        mxu_tables: K8's `build_mxu_face_tables(tris)` where the caller
            keeps them (built here when the route applies and None).
        any_hit_tree: a function from a triangle tensor to its cached
            any-hit tree (`MeshDeviceState.any_hit_tree`), for the exact
            mode's dense any-hit; without it each query builds its own on
            the card (`cuda_kernels.segments_occluded`).
        hrtf: a measured binaural set (`rir.hrtf.HRTFSet`): each ear's
            per-band power at the arrival direction weights the deposits
            in place of the spherical head's, its band-power table computed
            once before the bounces.

    Returns (E, C_out, B, n_bins) pressure^2 energies: C_out = C for omni;
    the ambisonic channels signed (energy times the arrival direction's
    gains); [left, right] energies times each ear's power gain.
    """
    return trace_energy_histogram_batch(
        [gen], tris, face_absorption, face_scattering, source_positions[None], listener_pos[None],
        n_rays=n_rays, max_depth=max_depth, n_bins=n_bins, bin_dt=bin_dt, c=c,
        face_occlusion=None if face_occlusion is None else face_occlusion[None], **kw,
    )[0]


def trace_energy_histogram_batch(
    gens: list,
    tris: torch.Tensor,
    face_absorption: torch.Tensor,
    face_scattering: torch.Tensor,
    source_positions: torch.Tensor,
    listener_pos: torch.Tensor,
    n_rays: int = 2000,
    max_depth: int = 50,
    n_bins: int = 512,
    bin_dt: float = 0.002,
    c: float = config.SPEED_OF_SOUND,
    *,
    tri_normals: torch.Tensor = None,
    face_occlusion: torch.Tensor = None,
    star=None,
    occlusion: bool = False,
    shared_visibility: bool = True,
    decimate: bool = False,
    encoding: str = "omni",
    sh_order: int = 1,
    tiled_tree=None,
    fh_table=None,
    any_hit_tree=None,
    mxu_tables=None,
    hrtf=None,
    transmission: bool = False,
    face_transmission: torch.Tensor = None,
) -> torch.Tensor:
    """`trace_energy_histogram_multi` for B scenes of one room in one bounce
    loop: source_positions (B, S, 3), listener_pos (B, C, 3), face_occlusion
    (B, P, F) or None, one generator per scene in `gens`. The B * S sources'
    rays are traced as one wavefront, scene-major; each bounce launches each
    kernel once for the batch, K3 and K4 reading each scene's listener
    points. Each scene draws from its own generator in the one-scene order
    and sizes and stops drawing when its rays are all dead (one host read of
    a (B,) alive mask per bounce), so scene b gets exactly the histograms of
    its one-scene trace with gens[b]. The exact rain mode (`star`,
    `occlusion`) traces one scene at a time. `transmission` lets rays pass
    through faces with the (F, B) coefficients `face_transmission` (see
    `_bounce`), each scene's roulette drawing from `transmission_generators`
    of its generator.

    Returns (B, S, C_out, n_bands, n_bins).
    """
    if transmission and face_transmission is None:
        raise ValueError("transmission=True requires face_transmission (F, B)")
    dev = tris.device
    n_scenes, per_scene = source_positions.shape[0], source_positions.shape[1]
    n_sources = n_scenes * per_scene
    n_bands = face_absorption.shape[1]
    cl = listener_pos.shape[1]
    if len(gens) != n_scenes or listener_pos.shape[0] != n_scenes:
        raise ValueError(f"{len(gens)} generators and {listener_pos.shape[0]} listener groups for {n_scenes} scenes")
    if n_scenes > 1 and (star is not None or occlusion and face_occlusion is None):
        raise NotImplementedError("the exact rain mode traces one scene at a time")
    _check_encoding(encoding, cl)
    c_out = encoding_channels(encoding, cl)
    total = n_sources * n_rays
    # One scene keeps its (C, 3) points: the kernels' one-scene form
    listener_pos = listener_pos.to(torch.float32).contiguous()
    lis = listener_pos[0] if n_scenes == 1 else listener_pos

    if tri_normals is None:
        tri_normals = cross3(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
        tri_normals = tri_normals / torch.clamp_min(norm3(tri_normals, keepdim=True), 1e-12)

    dirs = _SceneDraws(gens, [True] * n_scenes, per_scene * n_rays, dev).each(
        lambda g, r: torch.randn((r, 3), generator=g, device=dev), (3,))
    state = (
        source_positions.reshape(n_sources, 3).to(torch.float32).repeat_interleave(n_rays, dim=0),
        dirs / norm3(dirs, keepdim=True),
        torch.full((total, n_bands), 1.0 / n_rays, dtype=torch.float32, device=dev),
        torch.zeros(total, dtype=torch.float32, device=dev),
        torch.ones(total, dtype=torch.bool, device=dev),
        torch.full((total,), -1, dtype=torch.int32, device=dev),
    )
    hist = torch.zeros((n_sources, c_out, n_bands, n_bins), dtype=torch.float32, device=dev)
    mxu_tables = _mxu_tables_for(tris, tiled_tree, mxu_tables)
    dense = tiled_tree is None and mxu_tables is None
    route = ((first_hit_table(tris) if fh_table is None else fh_table) if dense else None, tiled_tree, mxu_tables)
    dense_rain = face_occlusion is None and star is None and bool(occlusion)
    tree = any_hit_tree(tris) if dense_rain and any_hit_tree is not None else None
    table = None
    if face_occlusion is not None:  # (B, P, F) -> (P, B * F): scene b's table at columns b * F
        table = face_occlusion[0] if n_scenes == 1 else face_occlusion.transpose(0, 1).reshape(
            face_occlusion.shape[1], -1)
    band_freqs = _band_centers(n_bands, dev)
    hrtf_bp = hrtf.band_powers(band_freqs) if hrtf is not None and encoding == "binaural" else None
    tau, trans_gens = None, None
    if transmission:
        tau = face_transmission.to(device=dev, dtype=torch.float32)
        trans_gens = transmission_generators(gens)
    phases = decimation_phases(n_rays, max_depth, decimate)
    for pi, (start, end, r_src) in enumerate(phases):
        if pi > 0:
            state = _halve_wavefront(state, n_sources, phases[pi - 1][2], r_src)
        rows = per_scene * r_src
        if n_scenes == 1:
            scene_faces = lambda f: f  # noqa: E731
        else:
            offset = torch.arange(n_scenes * rows, device=dev) // rows * face_occlusion.shape[-1]
            scene_faces = offset.add  # noqa: E731
        vis = (table, star, bool(occlusion), bool(shared_visibility), tree, scene_faces)
        for _ in range(start, end):
            # All rays of a scene dead: the reference's while-loop exit, per scene
            live = state[4].reshape(n_scenes, rows).any(dim=1).tolist()
            if not any(live):
                break
            state, add = _bounce(
                _SceneDraws(gens, live, rows, dev), state, tris, route, tri_normals, face_absorption,
                face_scattering, vis, lis, n_sources, n_rays, n_bins, bin_dt, c, encoding, sh_order, band_freqs,
                hrtf, hrtf_bp, None if tau is None else (tau, _SceneDraws(trans_gens, live, rows, dev)),
            )
            hist += add
    return hist.reshape(n_scenes, per_scene, c_out, n_bands, n_bins)


def _log_band_weights(freqs: torch.Tensor, band_freqs: torch.Tensor) -> torch.Tensor:
    """(B, n_freq) piecewise-linear log-frequency weights between band centres
    (weights of each frequency sum to 1)."""
    n_bands = band_freqs.shape[0]
    n_freq = freqs.shape[0]
    if n_bands == 1:
        return torch.ones((1, n_freq), dtype=torch.float32, device=freqs.device)
    logf = torch.log(torch.clamp_min(freqs, 1.0))
    logb = torch.log(band_freqs)
    idx_hi = torch.clamp(torch.searchsorted(logb, logf), 1, n_bands - 1)
    idx_lo = idx_hi - 1
    w_hi = torch.clamp((logf - logb[idx_lo]) / torch.clamp_min(logb[idx_hi] - logb[idx_lo], 1e-9), 0.0, 1.0)
    w = torch.zeros((n_bands, n_freq), dtype=torch.float32, device=freqs.device)
    cols = torch.arange(n_freq, device=freqs.device)
    w[idx_lo, cols] += 1.0 - w_hi
    w[idx_hi, cols] += w_hi
    return w


def _interp_envelope(env_bins: torch.Tensor, n_samples: int, bin_samples: float) -> torch.Tensor:
    """Upsample (..., n_bins) bin envelopes to sample resolution by gather
    linear interpolation (the reference's CPU formulation)."""
    n_bins = env_bins.shape[-1]
    t_samples = torch.arange(n_samples, device=env_bins.device) / bin_samples - 0.5
    lo = torch.clamp(torch.floor(t_samples).long(), 0, n_bins - 1)
    hi = torch.clamp(lo + 1, 0, n_bins - 1)
    frac = torch.clamp(t_samples - lo, 0.0, 1.0)
    return env_bins[..., lo] * (1 - frac) + env_bins[..., hi] * frac


def synthesize_ir_from_histogram(
    gen: torch.Generator,
    hist: torch.Tensor,
    band_freqs: torch.Tensor,
    n_samples: int,
    bin_dt: float,
    sr: int = config.SAMPLE_RATE,
    encoding: str = "omni",
) -> torch.Tensor:
    """Turn (..., C, B, n_bins) energy histograms into (..., C, n_samples) IRs.

    Band-limited Gaussian noise carriers are envelope-shaped so each bin's
    time-integrated squared pressure equals its energy. Omni capsules get
    independent carriers per capsule and band (diffuse-field decorrelation);
    the one-point encodings share one carrier per band across their
    channels. An ambisonic channel's envelope is its signed energy over
    sqrt(E_W) (covariance matching), so X/W carries the histogram's signed
    ratio; each binaural ear's envelope is the square root of its own energy
    (the shared carrier keeps the ears coherent).
    """
    *lead, c_out, n_bands, n_bins = hist.shape
    dev = hist.device
    bin_samples = bin_dt * sr
    n_fft = n_samples  # exact length, as the reference's CPU branch
    n_freq = n_fft // 2 + 1
    freqs = torch.arange(n_freq, device=dev) * (sr / n_fft)
    filt = torch.sqrt(_log_band_weights(freqs, band_freqs.to(torch.float32)))  # (B, n_freq)

    if encoding == "omni":
        white = torch.randn((*lead, c_out, n_bands, n_fft), generator=gen, device=dev)
    else:
        white = torch.randn((*lead, 1, n_bands, n_fft), generator=gen, device=dev)
    spec = torch.fft.rfft(white, dim=-1) * filt
    carriers = torch.fft.irfft(spec, n=n_fft, dim=-1)[..., :n_samples]
    var = torch.mean(carriers**2, dim=-1, keepdim=True) + 1e-20

    # Ambisonics: W (unit gain) carries the energy, the other channels carry
    # signed direction-weighted energy
    e_ref = hist if encoding in ("omni", "binaural") else torch.clamp_min(hist[..., 0:1, :, :], 0.0)
    env_bins = hist / torch.sqrt(torch.clamp_min(e_ref, 1e-20) * bin_samples)
    env = _interp_envelope(env_bins, n_samples, bin_samples)
    return torch.sum(carriers / torch.sqrt(var) * env, dim=-2).to(torch.float32)


def _linear_phase(delay_samp: torch.Tensor, n_samples: int) -> torch.Tensor:
    """exp(-2 pi j k delay / N) on the rfft grid, exact at any IR length: the
    delay splits into integer and fractional parts and (k * d_int) mod N is
    formed in integer arithmetic. (..., n_freq) complex64."""
    n_freq = n_samples // 2 + 1
    d_int = torch.floor(delay_samp).to(torch.int64)
    d_frac = (delay_samp - d_int.to(torch.float32))[..., None]
    d_mod = torch.remainder(d_int, n_samples)[..., None]
    d_hi = d_mod >> 8
    d_lo = d_mod & 255
    k_row = torch.arange(n_freq, device=delay_samp.device)
    prod_mod = torch.remainder(
        torch.remainder(torch.remainder(k_row * d_hi, n_samples) << 8, n_samples) + k_row * d_lo,
        n_samples,
    )
    phase = (-2.0 * math.pi / n_samples) * (prod_mod.to(torch.float32) + k_row.to(torch.float32) * d_frac)
    return torch.complex(torch.cos(phase), torch.sin(phase))


def _binaural_direct_ir(dirs, amp, dist, n_samples: int, sr: int, c: float, hrtf=None) -> torch.Tensor:
    """Exact binaural direct paths of the analytic head: per-ear Woodworth
    ITD and spherical-head shadow magnitude on the full rfft grid,
    synthesised with a linear phase. dirs (E, 3) are receiver -> source unit
    vectors, amp (E,) and dist (E,) the head-centre amplitude and distance;
    arrivals outside [0, n_samples - 1) are dropped. With a measured set
    `hrtf`, the interpolated HRIR's full spectrum at the head-centre delay
    replaces the analytic magnitude and ITD (the measured ITD, ILD and
    pinna cues); arrivals whose HRIR would not fit before n_samples are
    dropped. Returns (E, 2, n_samples)."""
    if hrtf is not None:
        h = hrtf.hrirs_at(dirs)  # (E, 2, N) at the engine rate
        delay_samp = dist[:, None] * (sr / c)  # (E, 1)
        in_range = (delay_samp >= 0.0) & (delay_samp < n_samples - h.shape[-1])
        h_spec = torch.fft.rfft(h, n=n_samples, dim=-1)  # (E, 2, F)
        spec = ((amp[:, None] * in_range)[..., None] * h_spec
                * _linear_phase(delay_samp.expand(h.shape[:2]), n_samples))
        return irfft_real(spec, n_samples).to(torch.float32)
    n_freq = n_samples // 2 + 1
    freqs = torch.arange(n_freq, device=dirs.device) * (sr / n_samples)
    mag = spherical_head_gains(dirs, freqs)  # (E, 2, F)
    delay_samp = dist[:, None] * (sr / c) + woodworth_itd(dirs, c=c) * sr  # (E, 2)
    in_range = (delay_samp >= 0.0) & (delay_samp < n_samples - 1)
    spec = (amp[:, None] * in_range)[..., None] * mag * _linear_phase(delay_samp, n_samples)
    return irfft_real(spec, n_samples).to(torch.float32)


def direct_paths_ir(
    tris: torch.Tensor,
    source_positions: torch.Tensor,
    listener_pos: torch.Tensor,
    n_samples: int,
    sr: int = config.SAMPLE_RATE,
    c: float = config.SPEED_OF_SOUND,
    encoding: str = "omni",
    sh_order: int = 3,
    tree=None,
    hrtf=None,
) -> torch.Tensor:
    """Exact direct paths for a batch of sources, with one occlusion query: a
    windowed sinc at delay d/c with amplitude visibility/(4 pi d), per omni
    capsule, or at the one listener point encoded with the ambisonic gains
    of the arrival direction at `sh_order` (clipped to the layout's order);
    "binaural" renders the analytic head, or the measured set `hrtf`
    (`_binaural_direct_ir`). `tree` is
    the any-hit tree of `tris` where the caller keeps one.
    Returns (E, C_out, n_samples)."""
    source_positions = torch.atleast_2d(source_positions).to(torch.float32)
    listener_pos = torch.atleast_2d(listener_pos).to(torch.float32)
    n_src, cl = source_positions.shape[0], listener_pos.shape[0]
    dev = source_positions.device

    vec = source_positions[:, None, :] - listener_pos[None, :, :]
    d = norm3(vec)  # (E, C)
    starts = listener_pos[None].expand(n_src, cl, 3).reshape(-1, 3)
    ends = source_positions.repeat_interleave(cl, dim=0)
    occ = segments_occluded(starts, ends, tris, tree).reshape(n_src, cl)
    amps = (~occ).to(torch.float32) / (4.0 * math.pi * torch.clamp_min(d, 1e-2))
    delays = d * sr / c
    if encoding == "binaural":
        dirs = vec[:, 0] / torch.clamp_min(d[:, 0:1], 1e-9)
        return _binaural_direct_ir(dirs, amps[:, 0], d[:, 0], n_samples, sr, c, hrtf)
    if encoding != "omni":
        dirs = vec[:, 0] / torch.clamp_min(d[:, 0:1], 1e-9)
        gains = ambisonic_encoding_gains(dirs, sh_order, encoding)  # (E, C_out)
        amps = amps[:, 0:1] * gains
        delays = delays[:, 0:1].expand_as(gains)
    c_out = amps.shape[1]

    n_taps = 32
    window = torch.as_tensor(np.hanning(2 * n_taps + 1), dtype=torch.float32, device=dev)
    tap_offsets = torch.arange(-n_taps, n_taps + 1, device=dev)
    d_int = torch.floor(delays).to(torch.int64)
    d_frac = delays - d_int
    x = tap_offsets.to(torch.float32) - d_frac[..., None]
    taps = torch.sinc(x) * window
    pos = d_int[..., None] + tap_offsets
    idx = torch.clamp(pos, 0, n_samples - 1)
    in_range = (pos >= 0) & (pos < n_samples)
    vals = amps[..., None] * taps * in_range
    ir = torch.zeros((n_src, c_out, n_samples), dtype=torch.float32, device=dev)
    return ir.scatter_add_(2, idx, vals)


def _diffraction_frame(source_pos: torch.Tensor, center: torch.Tensor):
    """(d (E,), axis, u, v (E, 3)): source->centre distance and an orthonormal frame."""
    d_vec = center[None] - source_pos
    d = norm3(d_vec)
    axis = d_vec / torch.clamp_min(d, 1e-9)[:, None]
    u = cross3(axis, _helper_axis(axis))
    u = u / torch.clamp_min(norm3(u), 1e-9)[:, None]
    v = cross3(axis, u)
    return d, axis, u, v


def _lattice_offsets(u, v, n_angles: int, n_radii: int) -> torch.Tensor:
    """(E, A, R, 3) polar lattice of bend offsets in the plane spanned by u, v."""
    dev = u.device
    angles = torch.arange(n_angles, device=dev) * (2.0 * math.pi / n_angles)
    # sin/cos of the f32 angles, correctly rounded (evaluated in f64)
    cos_a = torch.cos(angles.double()).float()[None, :, None, None]
    sin_a = torch.sin(angles.double()).float()[None, :, None, None]
    radii = torch.as_tensor(np.geomspace(0.05, 4.0, n_radii), dtype=torch.float32, device=dev)
    return (cos_a * u[:, None, None, :] + sin_a * v[:, None, None, :]) * radii[None, None, :, None]


def _graph_detour(tris, source_pos, center, order: int, n_angles: int = 12, n_radii: int = 4, tree=None):
    """Multi-bend detour search for E sources: layered shortest path over bend
    candidates (min-plus Bellman-Ford on a DAG of `order` stations, capped at
    4), with all candidate legs checked in one occlusion query.

    Returns (found (E,), dist to the last bend (E,), last bend (E, 3),
    per-bend local detours (E, S) with zeros for unused bends).
    """
    e_n = source_pos.shape[0]
    dev = source_pos.device
    d, axis, u, v = _diffraction_frame(source_pos, center)
    s_n = max(2, min(int(order), 4))
    p_n = n_angles * n_radii
    n_nodes = s_n * p_n

    fracs = (torch.arange(s_n, device=dev) + 1.0) / (s_n + 1.0)
    centers = source_pos[:, None, :] + fracs[None, :, None] * (d[:, None] * axis)[:, None, :]
    offs = _lattice_offsets(u, v, n_angles, n_radii).reshape(e_n, 1, p_n, 3)
    nodes = (centers[:, :, None, :] + offs).reshape(e_n, n_nodes, 3)

    # Every candidate leg in one query: source->node, node->node (all pairs;
    # the station order is enforced below) and node->listener. Each leg
    # overshoots its end a little so a candidate ON an occluder surface
    # cannot slip through the endpoint margin.
    over = 5e-4
    src_b = source_pos[:, None, :].expand(e_n, n_nodes, 3)
    cen_b = center[None, None, :].expand(e_n, n_nodes, 3)
    starts = torch.cat([src_b, nodes.repeat_interleave(n_nodes, dim=1), nodes], dim=1)
    raw_ends = torch.cat([nodes, nodes.repeat(1, n_nodes, 1), cen_b], dim=1)
    g = raw_ends - starts
    ends = raw_ends + over * g / torch.clamp_min(norm3(g, keepdim=True), 1e-9)
    occ = segments_occluded(starts.reshape(-1, 3), ends.reshape(-1, 3), tris, tree).reshape(e_n, -1)
    occ_src = occ[:, :n_nodes]
    occ_pair = occ[:, n_nodes : n_nodes + n_nodes * n_nodes].reshape(e_n, n_nodes, n_nodes)
    occ_lis = occ[:, n_nodes + n_nodes * n_nodes :]

    len_src = norm3(nodes - source_pos[:, None])
    len_lis = norm3(center[None, None] - nodes)
    len_pair = norm3(nodes[:, None, :, :] - nodes[:, :, None, :])  # [e, i, j] = |n_j - n_i|

    inf = math.inf
    # A few centimetres per station hop make the relaxation prefer the
    # fewest-bend representative of the same detour.
    hop = 0.05
    w_src = torch.where(occ_src, inf, len_src + hop)
    w_lis = torch.where(occ_lis, inf, len_lis)
    sta_of = torch.arange(n_nodes, device=dev) // p_n
    fwd = sta_of[None, :] > sta_of[:, None]
    w_pair = torch.where(fwd[None] & ~occ_pair, len_pair + hop, inf)

    dist = w_src
    parent = torch.full((e_n, n_nodes), -1, dtype=torch.int64, device=dev)
    for _ in range(s_n - 1):
        best_via, best_from = (dist[:, :, None] + w_pair).min(dim=1)
        better = best_via < dist
        parent = torch.where(better, best_from, parent)
        dist = torch.minimum(dist, best_via)

    total = dist + w_lis
    last = torch.argmin(total, dim=1)
    rows = torch.arange(e_n, device=dev)
    found = torch.isfinite(total[rows, last])

    # Backtrace (<= s_n nodes) collecting per-bend local detours
    # delta_i = |p_{i-1} p_i| + |p_i p_{i+1}| - |p_{i-1} p_{i+1}|.
    cur = last
    nxt_pos = center[None].expand(e_n, 3)
    deltas = torch.zeros((e_n, s_n), dtype=torch.float32, device=dev)
    slot = torch.zeros(e_n, dtype=torch.int64, device=dev)
    slots = torch.arange(s_n, device=dev)
    for _ in range(s_n):
        cur_c = torch.clamp_min(cur, 0)
        cur_pos = nodes[rows, cur_c]
        par = parent[rows, cur_c]
        prev_pos = torch.where((par < 0)[:, None], source_pos, nodes[rows, torch.clamp_min(par, 0)])
        delta = torch.clamp_min(
            norm3(cur_pos - prev_pos) + norm3(nxt_pos - cur_pos) - norm3(nxt_pos - prev_pos), 0.0
        )
        live = cur >= 0
        deltas = torch.where(live[:, None] & (slots[None] == slot[:, None]), delta[:, None], deltas)
        cur = torch.where(live, par, torch.full_like(par, -2))
        nxt_pos = torch.where(live[:, None], prev_pos, nxt_pos)
        slot = slot + live.to(torch.int64)
    return found, dist[rows, last], nodes[rows, last], deltas


def _synth_bent_component(gain_b, path, bend, listener_pos, band_freqs, n_samples, sr, c,
                          encoding="omni", sh_order=3, hrtf=None):
    """Frequency-domain synthesis of bent-path arrivals.

    gain_b: (E, C, B) per-band amplitude gains (zero where inactive); path:
    (E, C) bent path lengths; bend: (E, 3) the last bend point, whose
    direction from the listener encodes the arrival at a one-point rig (the
    ambisonic gains, or the spherical head's shadow magnitude and per-ear
    Woodworth ITD phase on the spectrum, or the measured set `hrtf`'s
    interpolated HRIR spectrum). Returns (E, C_out, n_samples).
    """
    n_freq = n_samples // 2 + 1
    freqs = torch.arange(n_freq, device=gain_b.device) * (sr / n_samples)
    w = _log_band_weights(freqs, band_freqs)  # (B, n_freq)
    g_f = gain_b @ w  # (E, C, n_freq) magnitude
    delay_samp = path * (sr / c)
    # Bent paths longer than the IR window are dropped, not wrapped
    g_f = g_f * (delay_samp < n_samples - 1)[..., None]
    spec = g_f * _linear_phase(delay_samp, n_samples)
    if encoding == "binaural":
        dirs = bend - listener_pos  # (E, 3): listener -> last bend
        dirs = dirs / torch.clamp_min(norm3(dirs, keepdim=True), 1e-9)
        if hrtf is not None:
            h_spec = torch.fft.rfft(hrtf.hrirs_at(dirs), n=n_samples, dim=-1)  # (E, 2, F)
            return irfft_real(spec[:, 0:1] * h_spec, n_samples).to(torch.float32)
        mag = spherical_head_gains(dirs, freqs)  # (E, 2, F)
        spec_ear = spec[:, 0:1] * mag * _linear_phase(woodworth_itd(dirs, c=c) * sr, n_samples)
        return irfft_real(spec_ear, n_samples).to(torch.float32)
    ir_caps = irfft_real(spec, n_samples).to(torch.float32)
    if encoding == "omni":
        return ir_caps
    dirs = bend - listener_pos  # (E, 3): listener -> last bend
    dirs = dirs / torch.clamp_min(norm3(dirs, keepdim=True), 1e-9)
    gains = ambisonic_encoding_gains(dirs, sh_order, encoding)  # (E, C_out)
    return gains[:, :, None] * ir_caps[:, 0:1]


def diffracted_path_ir(
    tris: torch.Tensor,
    source_positions: torch.Tensor,
    listener_pos: torch.Tensor,
    band_freqs: torch.Tensor,
    n_samples: int,
    sr: int = config.SAMPLE_RATE,
    c: float = config.SPEED_OF_SOUND,
    n_angles: int = 16,
    n_radii: int = 12,
    order: int = 1,
    tris_graph: torch.Tensor = None,
    encoding: str = "omni",
    sh_order: int = 3,
    tree=None,
    tree_graph=None,
    hrtf=None,
) -> torch.Tensor:
    """Knife-edge diffraction for OCCLUDED direct paths, E sources at once.

    Where the straight source->capsule segment is blocked, the shortest
    one-bend detour is searched on a polar lattice in the mid-plane (both legs
    must be clear); with `order` >= 2 a layered multi-bend graph
    (_graph_detour) takes over where no single bend clears. Each bend
    attenuates by the Maekawa fit A(N) = 10 log10(3 + 20 N) dB, N = 2 delta f / c.
    Candidate legs are checked against `tris_graph` when given (an acoustic
    LOD of a big mesh); the trigger always uses `tris`. Unoccluded pairs
    contribute zero. For FOA the arrival is encoded with the gains of the
    last bend's direction. `tree` and `tree_graph` are the any-hit trees of
    `tris` and `tris_graph` where the caller keeps them. Returns (E, C_out,
    n_samples).
    """
    source_positions = torch.atleast_2d(source_positions).to(torch.float32)
    listener_pos = torch.atleast_2d(listener_pos).to(torch.float32)
    e_n, cl = source_positions.shape[0], listener_pos.shape[0]
    center = listener_pos.mean(dim=0)
    band_freqs = band_freqs.to(torch.float32)
    leg_tris, leg_tree = (tris, tree) if tris_graph is None else (tris_graph, tree_graph)

    # The trigger: direct-path occlusion per (source, capsule), capsule -> source
    occ_direct = segments_occluded(
        listener_pos.repeat(e_n, 1), source_positions.repeat_interleave(cl, dim=0), tris, tree
    ).reshape(e_n, cl)

    d, axis, u, v = _diffraction_frame(source_positions, center)
    mid = 0.5 * (source_positions + center[None])
    bends = (mid[:, None, None, :] + _lattice_offsets(u, v, n_angles, n_radii)).reshape(e_n, -1, 3)
    k = bends.shape[1]
    src_b = source_positions[:, None, :]
    d1 = norm3(bends - src_b)
    d2c = norm3(bends - center)
    over = 5e-4
    ext1 = bends + over * (bends - src_b) / torch.clamp_min(d1, 1e-9)[..., None]
    ext2 = bends + over * (bends - center) / torch.clamp_min(d2c, 1e-9)[..., None]
    leg_starts = torch.cat([src_b.expand(e_n, k, 3), center.expand(e_n, k, 3)], dim=1)
    occ_legs = segments_occluded(
        leg_starts.reshape(-1, 3), torch.cat([ext1, ext2], dim=1).reshape(-1, 3), leg_tris, leg_tree
    ).reshape(e_n, 2, k)
    detour = torch.where(~occ_legs[:, 0] & ~occ_legs[:, 1], d1 + d2c, math.inf)
    best = torch.argmin(detour, dim=1)
    rows = torch.arange(e_n, device=d1.device)
    bend = bends[rows, best]
    found = torch.isfinite(detour[rows, best])

    d2 = norm3(listener_pos[None] - bend[:, None])  # (E, C)
    path = d1[rows, best][:, None] + d2
    deltas = torch.clamp_min(path - norm3(listener_pos[None] - src_b), 0.0)[..., None]  # (E, C, 1)

    if order >= 2:
        found_g, dist_last, bend_g, deltas_s = _graph_detour(leg_tris, source_positions, center, order,
                                                             tree=leg_tree)
        path_g = dist_last[:, None] + norm3(listener_pos[None] - bend_g[:, None])
        deltas_g = deltas_s[:, None, :].expand(e_n, cl, deltas_s.shape[1])
        use_graph = ~found & found_g
        found = found | found_g
        bend = torch.where(use_graph[:, None], bend_g, bend)
        path = torch.where(use_graph[:, None], path_g, path)
        deltas = torch.where(
            use_graph[:, None, None], deltas_g, F.pad(deltas, (0, deltas_g.shape[2] - 1))
        )

    # Bends below the lattice's resolution (sub-5 mm local detour) are path
    # representation, not physical edges, and pay no knife-edge floor.
    bend_eps = 5e-3
    fresnel = 2.0 * deltas[..., None] * band_freqs / c  # (E, C, S, B)
    att_db = 10.0 * torch.log10(3.0 + 20.0 * fresnel)
    att_db = torch.sum(att_db * (deltas[..., None] > bend_eps), dim=2)  # (E, C, B)
    no_bend = torch.all(deltas <= bend_eps, dim=2)
    floor_db = 10.0 * float(np.log10(np.float32(3.0)))
    att_db = torch.where(no_bend[..., None], floor_db, att_db)
    gain_b = 10.0 ** (-att_db / 20.0) / (4.0 * math.pi * torch.clamp_min(path, 1e-2))[..., None]
    gain_b = gain_b * (occ_direct & found[:, None])[..., None]
    return _synth_bent_component(gain_b, path, bend, listener_pos, band_freqs, n_samples, sr, c,
                                 encoding, sh_order, hrtf)


def face_rain_occlusion(tris: torch.Tensor, tri_normals: torch.Tensor, listener_points: torch.Tensor,
                        tree=None) -> torch.Tensor:
    """Per-face diffuse-rain visibility: (P, F) bool, True where the segment
    face centroid -> listener point is blocked. The start is offset off the
    surface on the listener's side. All P x F segments go in one query,
    through `tree` (the any-hit tree of `tris`) where the caller keeps one."""
    listener_points = torch.atleast_2d(listener_points).to(torch.float32)
    centroids = tris.mean(dim=1)  # (F, 3)
    to_l = listener_points[:, None, :] - centroids[None]  # (P, F, 3)
    n_or = torch.where((dot3(tri_normals[None], to_l) >= 0)[..., None], tri_normals[None], -tri_normals[None])
    starts = centroids[None] + 1e-4 * n_or
    ends = listener_points[:, None, :].expand_as(starts)
    return segments_occluded(starts.reshape(-1, 3), ends.reshape(-1, 3), tris, tree).reshape(
        listener_points.shape[0], -1
    )


def trace_rirs_multi(
    gen: torch.Generator,
    tris: torch.Tensor,
    face_absorption: torch.Tensor,
    face_scattering: torch.Tensor,
    source_positions: torch.Tensor,
    listener_pos: torch.Tensor,
    n_samples: int,
    *,
    face_occlusion: torch.Tensor = None,
    **kw,
) -> torch.Tensor:
    """RIRs for a batch of sources against one listener group: stochastic
    tail on `tris` (the acoustic mesh) + exact direct path on `tris_direct`
    (default `tris`) + optional knife-edge diffraction. `encoding` is "omni"
    (one channel per capsule), or "foa", "sh2", "sh3" or "binaural" (one
    listener point); the direct and diffracted paths encode at
    `sh_order_direct`, the tail at `sh_order_indirect`, each clipped to the
    layout's order. The tail's rain visibility is `face_occlusion`, `star`
    or `occlusion`, its bounce first hit K7 on `tiled_tree` where given, else
    K8 on `mxu_tables` where its flag is on, else K1 on `fh_table`; every
    any-hit query takes its mesh's tree from
    `any_hit_tree` (see trace_energy_histogram_multi). A measured binaural
    set `hrtf` (`rir.hrtf.HRTFSet`) renders the tail, the direct and the
    diffracted paths in place of the analytic head. The keywords are
    `trace_rirs_batch`'s. Returns (C_out, E, n_samples)."""
    return trace_rirs_batch(
        [gen], tris, face_absorption, face_scattering, torch.atleast_2d(source_positions)[None], listener_pos[None],
        n_samples, face_occlusion=None if face_occlusion is None else face_occlusion[None], **kw,
    )[0]


def trace_rirs_batch(
    gens: list,
    tris: torch.Tensor,
    face_absorption: torch.Tensor,
    face_scattering: torch.Tensor,
    source_positions: torch.Tensor,
    listener_pos: torch.Tensor,
    n_samples: int,
    sr: int = config.SAMPLE_RATE,
    n_rays: int = 2000,
    max_depth: int = 50,
    bin_dt: float = 0.002,
    c: float = config.SPEED_OF_SOUND,
    *,
    tri_normals: torch.Tensor = None,
    face_occlusion: torch.Tensor = None,
    star=None,
    occlusion: bool = False,
    shared_visibility: bool = True,
    tris_direct: torch.Tensor = None,
    diffraction: bool = False,
    diffraction_order: int = 1,
    tris_diffraction_graph: torch.Tensor = None,
    decimate: bool = False,
    encoding: str = "omni",
    sh_order_direct: int = 3,
    sh_order_indirect: int = 1,
    tiled_tree=None,
    fh_table=None,
    any_hit_tree=None,
    mxu_tables=None,
    hrtf=None,
    transmission: bool = False,
    face_transmission: torch.Tensor = None,
) -> list:
    """`trace_rirs_multi` for B scenes of one room: source_positions (B, S,
    3), listener_pos (B, C, 3), face_occlusion (B, P, F) or None, one
    generator per scene. The tail of every scene is traced in one bounce
    loop (`trace_energy_histogram_batch`); the synthesis, the direct and the
    diffracted paths run scene by scene. Scene b gets exactly its one-scene
    RIRs with gens[b]. Returns B tensors of (C_out, S, n_samples)."""
    n_bins = int(np.ceil(n_samples / sr / bin_dt)) + 1
    hist = trace_energy_histogram_batch(
        gens, tris, face_absorption, face_scattering, source_positions, listener_pos,
        n_rays=n_rays, max_depth=max_depth, n_bins=n_bins, bin_dt=bin_dt, c=c,
        tri_normals=tri_normals, face_occlusion=face_occlusion, star=star, occlusion=occlusion,
        shared_visibility=shared_visibility, decimate=decimate, encoding=encoding, sh_order=sh_order_indirect,
        tiled_tree=tiled_tree, fh_table=fh_table, any_hit_tree=any_hit_tree, mxu_tables=mxu_tables,
        hrtf=hrtf, transmission=transmission, face_transmission=face_transmission,
    )  # (B, E, C_out, B, bins)
    band_freqs = _band_centers(face_absorption.shape[1], tris.device)
    td = tris if tris_direct is None else tris_direct
    tree_of = any_hit_tree if any_hit_tree is not None else (lambda _: None)
    out = []
    for gen, h, src, lis in zip(gens, hist, source_positions, listener_pos):
        irs = synthesize_ir_from_histogram(gen, h, band_freqs, n_samples, bin_dt, sr=sr, encoding=encoding)
        irs = irs + direct_paths_ir(td, src, lis, n_samples, sr=sr, c=c,
                                    encoding=encoding, sh_order=sh_order_direct, tree=tree_of(td), hrtf=hrtf)
        if diffraction:
            irs = irs + diffracted_path_ir(
                td, src, lis, band_freqs, n_samples, sr=sr, c=c,
                order=int(diffraction_order), tris_graph=tris_diffraction_graph,
                encoding=encoding, sh_order=sh_order_direct, tree=tree_of(td),
                tree_graph=None if tris_diffraction_graph is None else tree_of(tris_diffraction_graph),
                hrtf=hrtf,
            )
        out.append(irs.movedim(0, 1))
    return out
