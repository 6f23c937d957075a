"""Transmission through faces in the port's tracer (rir/raytracer.py `_bounce`)
and rlr backend, against the JAX package's.

- The reference's three cases (tests/test_raytracer.py): a room fully
  divided by a wall passes no energy with transmission off and a bounded,
  nonzero tail with it on (under 0.2 of the open room's); more transmissive
  walls leak more (30x tau, over 3x the energy); the world state's
  `rlr_kwargs` flag reaches the trace (a Curtain wall: no energy off, some
  on).
- The leaked energy (the energy histogram behind the wall, tau 0.1 and
  0.3) is held to the JAX tracer's: their means over eight seeds each agree
  within 25 % (the two packages draw different random numbers, so the
  comparison is statistical; the seed-to-seed spread of either is 8-12 %,
  so 25 % is over 4 standard errors of the difference of means).
- tau = 0 gives the bits of a trace without transmission (the roulette draws
  from generators of its own), on the single and the batched tracer.
- A batch of scenes with transmission equals its scenes traced alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiblelight_tpu.rir.raytracer import trace_energy_histogram_multi as jax_trace_energy_histogram_multi
from audiblelight_tpu_torch.geometry.mesh import TriMesh, box_mesh
from audiblelight_tpu_torch.rir.raytracer import trace_energy_histogram_multi, trace_rirs_batch, trace_rirs_multi
from audiblelight_tpu_torch.worldstate.mesh_backend import WorldStateRLR

torch.set_num_threads(1)

ROOM = np.array([6.0, 4.0, 3.0])
SRC = np.array([[1.5, 2.0, 1.5]], np.float32)  # left of the wall
LIS = np.array([[4.5, 2.0, 1.5]], np.float32)  # right of the wall
KW = dict(n_samples=2400, sr=24000, n_rays=2048, max_depth=24, occlusion=True)


def _divided_room(tau: float = 0.02, n_bands: int = 2):
    """A 6x4x3 room divided at x=3 by a wall box that overlaps the shell."""
    room = box_mesh(extents=ROOM, center=ROOM / 2)
    wall = box_mesh(extents=[0.2, 4.4, 3.4], center=[3.0, 2.0, 1.5], inward_normals=False)
    tris = np.concatenate([room.triangles, wall.triangles]).astype(np.float32)
    f = len(tris)
    return (tris, np.full((f, n_bands), 0.3, np.float32), np.full((f,), 0.3, np.float32),
            np.full((f, n_bands), tau, np.float32))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _port_ir(seed, tris, absorption, scatter, tau=None, **kw):
    tris, absorption, scatter, src, lis = _t(tris, absorption, scatter, SRC, LIS)
    extra = {} if tau is None else dict(face_transmission=torch.as_tensor(tau), transmission=True)
    return trace_rirs_multi(_gen(seed), tris, absorption, scatter, src, lis, **{**KW, **kw}, **extra).numpy()


def test_transmission_through_dividing_wall():
    tris, absorption, scatter, tau = _divided_room(0.02)
    assert np.abs(_port_ir(7, tris, absorption, scatter)).max() == 0.0  # divided: no path at all
    e_on = float(np.sum(_port_ir(7, tris, absorption, scatter, tau) ** 2))
    assert e_on > 0.0
    room = box_mesh(extents=ROOM, center=ROOM / 2)
    open_tris = room.triangles.astype(np.float32)
    e_open = float(np.sum(_port_ir(7, open_tris, np.full((12, 2), 0.3, np.float32), np.full((12,), 0.3, np.float32),
                                   occlusion=False) ** 2))
    assert e_on < 0.2 * e_open


def test_transmission_scales_with_tau():
    energies = []
    for tau_val in (1e-3, 3e-2):
        tris, absorption, scatter, tau = _divided_room(tau_val)
        energies.append(float(np.sum(_port_ir(3, tris, absorption, scatter, tau) ** 2)))
    assert energies[1] > 3.0 * energies[0]


def test_transmission_config_plumbs_through_backend():
    room = box_mesh(extents=ROOM, center=ROOM / 2)
    wall = box_mesh(extents=[0.2, 4.4, 3.4], center=[3.0, 2.0, 1.5], inward_normals=False)
    soup = TriMesh(vertices=np.concatenate([room.vertices, wall.vertices]),
                   faces=np.concatenate([room.faces, wall.faces + len(room.vertices)]))
    irs = {}
    for flag in (False, True):
        # A Curtain: tau ~0.2 at 500 Hz through the wall's two faces
        state = WorldStateRLR(mesh=soup, material="Curtain", seed=0, sample_rate=24000, device="cpu",
                              rlr_kwargs=dict(transmission=flag, indirect_ray_count=4096, indirect_ray_depth=24,
                                              max_ir_length=0.1, sample_rate=24000))
        assert state.cfg["transmission"] is flag
        assert (state.device_state.transmission is not None) == flag
        state.add_microphone("monocapsule", [4.5, 2.0, 1.5], "mic000")
        state._add_emitters_without_validating(np.array([[1.5, 2.0, 1.5]]), "src000")
        state.simulate()
        irs[flag] = state.irs["mic000"]
    assert float(np.sum(irs[False] ** 2)) == 0.0
    assert float(np.sum(irs[True] ** 2)) > 0.0


@pytest.mark.parametrize("tau", [0.1, 0.3])
def test_leaked_energy_matches_the_jax_tracer(tau):
    """The energy histogram behind the wall: the port's and the JAX
    tracer's means over eight seeds each."""
    tris, absorption, scatter, taus = _divided_room(tau)
    kw = dict(n_rays=2048, max_depth=24, n_bins=60, bin_dt=0.002, occlusion=True, transmission=True)
    port = [float(trace_energy_histogram_multi(_gen(s), *_t(tris, absorption, scatter, SRC, LIS),
                                               face_transmission=torch.as_tensor(taus), **kw).sum())
            for s in range(8)]
    ref = [float(np.asarray(jax_trace_energy_histogram_multi(
        jax.random.PRNGKey(s), *(jnp.asarray(x) for x in (tris, absorption, scatter, SRC, LIS)), 1,
        face_transmission=jnp.asarray(taus), **kw)).sum()) for s in range(8)]
    print(f"tau {tau}: leaked energy, port mean {np.mean(port):.4g} (sd {np.std(port):.3g}), "
          f"jax mean {np.mean(ref):.4g} (sd {np.std(ref):.3g})")
    assert min(port) > 0 and min(ref) > 0
    assert abs(np.mean(port) / np.mean(ref) - 1.0) < 0.25


@pytest.mark.parametrize("decimate", [False, True])
def test_zero_tau_equals_no_transmission(decimate):
    """tau = 0: the same bits as transmission off, in a room with open paths."""
    tris, absorption, scatter, tau = _divided_room(0.0)
    lis = np.array([[2.0, 1.0, 1.0]], np.float32)
    kw = dict(KW, n_rays=2048, max_depth=24, decimate=decimate)
    t, a, s, src, li = _t(tris, absorption, scatter, SRC, lis)
    off = trace_rirs_multi(_gen(5), t, a, s, src, li, **kw)
    zero = trace_rirs_multi(_gen(5), t, a, s, src, li, face_transmission=torch.as_tensor(tau), transmission=True,
                            **kw)
    assert off.abs().max() > 0
    assert torch.equal(off, zero)


def test_batch_with_transmission_equals_scenes_alone():
    tris, absorption, scatter, tau = _divided_room(0.05)
    t, a, s, ta = _t(tris, absorption, scatter, tau)
    srcs = torch.tensor([[[1.5, 2.0, 1.5], [1.0, 1.0, 1.0]], [[4.8, 3.0, 2.0], [5.5, 1.0, 1.2]],
                         [[2.0, 3.2, 0.8], [1.2, 0.7, 2.2]]])
    lis = torch.tensor([[[4.5, 2.0, 1.5]], [[1.5, 2.5, 1.5]], [[2.5, 1.0, 1.0]]])
    kw = dict(n_samples=1200, sr=24000, n_rays=512, max_depth=12, occlusion=False,
              face_occlusion=torch.zeros((3, 1, t.shape[0]), dtype=torch.bool), face_transmission=ta,
              transmission=True)
    batch = trace_rirs_batch([_gen(10 + i) for i in range(3)], t, a, s, srcs, lis, **kw)
    for i in range(3):
        alone = trace_rirs_batch([_gen(10 + i)], t, a, s, srcs[i:i + 1], lis[i:i + 1],
                                 **dict(kw, face_occlusion=kw["face_occlusion"][i:i + 1]))[0]
        assert torch.equal(batch[i], alone), i
