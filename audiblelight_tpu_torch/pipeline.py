"""The fused scene render: placed scene arrays -> int16 WAV payload on the card.

Counterpart of audiblelight_tpu/pipeline.py's FusedSceneRenderer.render_mix
(the device program of the SELD dataset generator and the benchmark): trace
the RIRs of every padded source, gather them per event, render the stems,
place them in the scene timeline, add the ambience bed and quantise to int16.
The reference compiles this into one XLA program; here it runs eagerly, one
kernel or PyTorch op after another, with the JAX key replaced by a
`torch.Generator`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from audiblelight_tpu_torch.geometry.mesh import TriMesh
from audiblelight_tpu_torch.io.audio import wav_write
from audiblelight_tpu_torch.render import (
    ScenePlan,
    ambience_bed_device,
    place_stems_device,
    quantize_mix_wav,
    render_event_stems_arrays,
)
from audiblelight_tpu_torch.rir.raytracer import trace_rirs_multi
from audiblelight_tpu_torch.worldstate.mesh_backend import MeshDeviceState, rain_mode


class FusedSceneRenderer:
    """Render whole scenes of one room, mic rig and bucket shape to WAV payloads.

    Arguments:
        state: the room's device state (mesh, materials, engine config).
        n_channels: output channels (omni capsules of the rig).
        buckets: (es, em, j, S) padded static/moving event counts, trajectory
            points and event samples of the scene plans it renders.
        n_sources: padded source count of the trace.
        t_scene: scene length in samples.
    """

    def __init__(self, state: MeshDeviceState, n_channels: int, buckets: tuple,
                 n_sources: int, t_scene: int):
        if not state.convex and rain_mode(state.cfg) != "face":
            raise ValueError(
                "the fused renderer on a nonconvex mesh needs per-face rain visibility "
                '(rain_visibility="face", or "auto" with mesh_simplification on)'
            )
        self.state = state
        self.device = state.device
        self.n_channels = int(n_channels)
        self.buckets = tuple(int(b) for b in buckets)
        self.n_sources = int(n_sources)
        self.t_scene = int(t_scene)

    @classmethod
    def from_mesh(cls, mesh: TriMesh, cfg: dict, capsules, buckets: tuple, n_sources: int,
                  t_scene: int, material: Optional[str] = None, device=None) -> "FusedSceneRenderer":
        """A renderer for `mesh` under engine config `cfg`, for the rig whose
        capsule positions are `capsules` (C, 3)."""
        state = MeshDeviceState.from_mesh(mesh, cfg, material=material, device=device)
        return cls(state, len(np.atleast_2d(capsules)), buckets, n_sources, t_scene)

    def rain_table(self, capsules) -> Optional[torch.Tensor]:
        """The (1, F') per-face rain table toward the rig's centroid (the
        reference's shared visibility), or None in a convex room."""
        if self.state.convex:
            return None
        centroid = np.atleast_2d(np.asarray(capsules, dtype=np.float64)).mean(axis=0, keepdims=True)
        return self.state.rain_occlusion_for(centroid)

    def trace(self, gen: torch.Generator, sources: torch.Tensor, listeners: torch.Tensor,
              face_occ: Optional[torch.Tensor]) -> torch.Tensor:
        """(C, n_sources, L) RIRs of the padded sources at the capsules."""
        st, cfg = self.state, self.state.cfg
        sr = int(cfg["sample_rate"])
        occl = not st.convex
        return trace_rirs_multi(
            gen, st.acoustic_tris, st.absorption, st.scattering, sources, listeners,
            n_samples=int(round(float(cfg["max_ir_length"]) * sr)),
            sr=sr,
            n_rays=int(cfg["indirect_ray_count"]),
            max_depth=min(int(cfg["indirect_ray_depth"]), 200),
            bin_dt=float(cfg["hist_bin_dt"]),
            c=float(cfg["speed_of_sound"]),
            tri_normals=st.acoustic_normals,
            face_occlusion=face_occ if occl else None,
            tris_direct=st.tris,
            diffraction=bool(cfg["diffraction"]) and occl,
            diffraction_order=max(1, int(cfg["max_diffraction_order"])),
            tris_diffraction_graph=st.diffraction_graph_tris,
            decimate=bool(cfg["ray_decimation"]),
        )

    def stems(self, gen, sources, listeners, face_occ, s_idx, m_idx, plan: ScenePlan) -> torch.Tensor:
        """(es + em, C, S) float stems: trace, per-event IR gather, render."""
        es, em, j, _ = self.buckets
        irs = self.trace(gen, sources, listeners, face_occ)  # (C, bucket, L)
        c, ir_len = irs.shape[0], irs.shape[-1]
        # -1 marks an empty slot (padded events, trajectory tails): a clamped
        # gather, then zeroed
        s_irs = irs[:, s_idx.clamp_min(0)] * (s_idx >= 0)[None, :, None]
        m_irs = irs[:, m_idx.clamp_min(0).reshape(-1)].reshape(c, em, j, ir_len)
        m_irs = m_irs * (m_idx >= 0)[None, :, :, None]
        return render_event_stems_arrays(
            plan.static_audio, s_irs.transpose(0, 1), plan.static_mask, plan.static_snr,
            plan.static_len, plan.static_place_len,
            plan.moving_audio, m_irs.transpose(0, 1), plan.moving_w, plan.moving_mask,
            plan.moving_snr, plan.moving_len, plan.moving_place_len, plan.ref_db,
        )

    def render_mix(self, gen: torch.Generator, sources, listeners, face_occ, s_idx, m_idx,
                   plan: ScenePlan, amb_on: float, amb_beta: float, amb_db: float) -> torch.Tensor:
        """One scene to its (C, T) int16 WAV payload on the renderer's device.

        Arguments:
            gen: the scene's generator (trace, noise carriers, ambience).
            sources: (n_sources, 3) padded source positions; listeners: (C, 3)
                capsules; face_occ: `rain_table(listeners)`.
            s_idx (es,), m_idx (em, j): event -> source maps, -1 = empty.
            plan: the scene's audio, weights, levels and start offsets.
            amb_on, amb_beta, amb_db: ambience on (1) or off (0), its
                power-law exponent (0 = white) and level.
        """
        if tuple(sources.shape) != (self.n_sources, 3):
            raise ValueError(f"sources must be ({self.n_sources}, 3), got {tuple(sources.shape)}")
        if tuple(listeners.shape) != (self.n_channels, 3):
            raise ValueError(f"listeners must be ({self.n_channels}, 3), got {tuple(listeners.shape)}")
        stems = self.stems(gen, sources, listeners, face_occ, s_idx, m_idx, plan)
        starts = torch.cat([plan.static_start, plan.moving_start])
        mix = place_stems_device(stems, starts, self.t_scene)
        if float(amb_on) != 0.0:
            bed = ambience_bed_device(gen, float(amb_beta), float(amb_db), self.n_channels,
                                      self.t_scene, device=self.device)
            mix = mix + float(amb_on) * bed
        return quantize_mix_wav(mix)


def renderer_from_numpy(world: dict, cfg: dict, plan: dict, scene_inputs: tuple,
                        t_scene: int, device=None):
    """Carry a world state and one scene's inputs, built elsewhere as numpy
    arrays, over to this package.

    Arguments:
        world: "tris" (F, 3, 3), "acoustic_tris" (F', 3, 3),
            "acoustic_normals" (F', 3), "absorption" (F', B),
            "scattering" (F',), "convex" (bool) and
            "diffraction_graph_tris" (F'', 3, 3) or None.
        cfg: engine config.
        plan: the ScenePlan fields (see render.ScenePlan).
        scene_inputs: (sources (n_sources, 3), capsules (C, 3), rain table
            (P, F') or None, s_idx (es,), m_idx (em, j)).
        t_scene: scene length in samples.

    Returns (renderer, (sources, listeners, face_occ, s_idx, m_idx, plan)) on
    `device`: pass a generator, these, and the ambience scalars to
    `renderer.render_mix`.
    """
    state = MeshDeviceState(
        world["tris"], world["acoustic_tris"], world["acoustic_normals"],
        world["absorption"], world["scattering"], convex=world["convex"],
        diffraction_graph_tris=world["diffraction_graph_tris"], cfg=cfg, device=device,
    )
    sources, capsules, rain, s_idx, m_idx = scene_inputs
    dev = state.device
    splan = ScenePlan.from_numpy(plan, dev)
    renderer = FusedSceneRenderer(
        state, len(capsules), (splan.static_audio.shape[0], splan.moving_audio.shape[0],
                               splan.moving_w.shape[2], splan.static_audio.shape[1]),
        len(sources), t_scene,
    )
    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)  # noqa: E731
    i64 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)  # noqa: E731
    face_occ = None if rain is None else torch.as_tensor(np.array(rain, dtype=bool), device=dev)
    return renderer, (f32(sources), f32(capsules), face_occ, i64(s_idx), i64(m_idx), splan)


def write_wav(path, payload: torch.Tensor, sample_rate: int) -> Path:
    """Write a (C, T) int16 payload from `render_mix` as a PCM WAV file."""
    path = Path(path)
    wav_write(path, payload.cpu().numpy(), int(sample_rate))
    return path
