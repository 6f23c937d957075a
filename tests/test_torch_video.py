"""The port's video path against the reference's: the panorama
(audiblelight_tpu_torch/viz/panorama.py), the MJPEG AVI and MP4 muxers
(io/avi.py, io/mp4.py), the H.264 shim (io/h264.py over
csrc/host/h264mux.c), event images and `Scene.generate(video=True)`.

Tolerances: the panorama's first hits go through the port's first-hit query
(its plain version here) and the reference's XLA query, whose `t` differ in
the last bits (XLA:CPU contracts multiply-adds, ROADMAP section 3); so hit
masks and face indices are equal but for grazing pixels, counted and
bounded at 0.1 % of the image, and every other pixel is within one uint8
step. The muxers write the reference's bytes for the same frames. The
H.264 cases are tests/test_h264.py's, skipped inside each test where the
shim does not build. Event images: the reference's pick for the same seed,
equal arrays. The scene video, given the same background, writes the
reference's AVI and GIF bytes, and its MP4's frames."""

import io
import json
import random
import shutil
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import audiblelight_tpu.viz as jviz
from audiblelight_tpu import Scene as JaxScene
from audiblelight_tpu import utils as jutils
from audiblelight_tpu.geometry.mesh import load_mesh as jax_load_mesh
from audiblelight_tpu.geometry.queries import ray_mesh_first_hit as jax_first_hit
from audiblelight_tpu.io.avi import write_mjpeg_avi as jax_avi
from audiblelight_tpu.io.mp4 import write_mjpeg_mp4 as jax_mp4
from audiblelight_tpu.viz.panorama import render_equirect_panorama as jax_panorama
from audiblelight_tpu_torch import synthesize
from audiblelight_tpu_torch import utils as tutils
from audiblelight_tpu_torch.core import Scene as PortScene
from audiblelight_tpu_torch.geometry.mesh import box_mesh, load_mesh, save_obj, scanned_like_room
from audiblelight_tpu_torch.io import h264
from audiblelight_tpu_torch.io.avi import read_avi_frame_count, write_mjpeg_avi
from audiblelight_tpu_torch.io.mp4 import write_mjpeg_mp4
from audiblelight_tpu_torch.viz import panorama

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SR = 16000


@pytest.fixture(scope="module", autouse=True)
def _restore_global_streams():
    """Placement draws from the global `random`, numpy and torch streams: leave
    them as this module found them."""
    states = random.getstate(), np.random.get_state(), torch.random.get_rng_state()
    yield
    random.setstate(states[0])
    np.random.set_state(states[1])
    torch.random.set_rng_state(states[2])


def mp4_sample_count(path: Path) -> int:
    """Frames of an MP4 from its `stsz` box (either codec's)."""
    raw = path.read_bytes()
    i = raw.index(b"stsz")
    return struct.unpack(">I", raw[i + 12:i + 16])[0]


def gif_frame_count(path: Path, fps: int = 10) -> int:
    """Video frames of a GIF: PIL's writer merges identical consecutive
    frames into one of their summed duration, so count by duration."""
    total = 0
    with Image.open(path) as im:
        for i in range(im.n_frames):
            im.seek(i)
            total += im.info["duration"]
    return total // int(1000 / fps)


# ---------------------------------------------------------------------------
# The panorama
# ---------------------------------------------------------------------------


def _hold_panorama(tris, cam, width, height, visuals=None):
    """The port's panorama against the reference's: faces equal but for
    grazing pixels (<= 0.1 %), the rest within one uint8 step."""
    got = panorama.render_equirect_panorama(tris, cam, width, height, visuals=visuals, device="cpu")
    want = jax_panorama(tris, cam, width, height, visuals=visuals)
    assert got.shape == want.shape == (height, width, 3) and got.dtype == np.uint8
    t, face = panorama.first_hits(tris, cam, width, height, device="cpu")
    dirs = panorama._equirect_dirs(width, height)
    t_j, face_j = (np.asarray(x) for x in jax_first_hit(np.broadcast_to(np.asarray(cam, np.float32), dirs.shape),
                                                         dirs, np.asarray(tris, np.float32)))
    odd = (face != face_j) | (np.isfinite(t) != np.isfinite(t_j))
    print(f"panorama {width}x{height}: {int(odd.sum())} grazing pixels of {odd.size}")
    assert odd.mean() <= 1e-3
    gap = np.abs(got.astype(int) - want.astype(int)).max(axis=-1).reshape(-1)
    assert gap[~odd].max() <= 1
    np.testing.assert_allclose(t[~odd & np.isfinite(t)], t_j[~odd & np.isfinite(t_j)], rtol=1e-4)
    return got


def test_box_panorama_matches_the_reference():
    """Inside a closed box every pixel hits; the ceiling fills the top rows."""
    b = box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25])
    img = _hold_panorama(np.asarray(b.triangles), [2.0, 1.5, 1.25], 160, 80)
    assert (img.sum(axis=-1) > 40).all()
    top = img[0].astype(int).sum(axis=-1)
    assert np.ptp(top) <= 0.2 * top.max()


def test_scanned_room_panorama_matches_the_reference():
    m = scanned_like_room(seed=2, subdivision_levels=2)
    img = _hold_panorama(m.triangles, [3.5, 2.5, 1.5], 160, 80)
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 50
    assert (img.sum(axis=-1) > 40).mean() > 0.98


def test_textured_glb_panorama_matches_the_reference(tmp_path):
    from tests.test_panorama import _write_textured_glb

    glb = tmp_path / "quad.glb"
    _write_textured_glb(glb)
    mesh, jmesh = load_mesh(glb), jax_load_mesh(glb)
    assert mesh.visuals is not None and mesh.visuals.any_textured
    got = _hold_panorama(mesh.triangles, [0.0, 0.0, 0.0], 256, 128, visuals=mesh.visuals)
    want = jax_panorama(jmesh.triangles, [0.0, 0.0, 0.0], 256, 128, visuals=jmesh.visuals)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    plain = panorama.render_equirect_panorama(mesh.triangles, [0.0, 0.0, 0.0], 256, 128, device="cpu")
    plit = plain.reshape(-1, 3).astype(int)
    plit = plit[plit.sum(axis=1) > 60]
    assert (plit[:, 2] > 2 * plit[:, 0]).sum() == 0


def test_panorama_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    b = box_mesh(extents=[4.0, 3.0, 2.5], center=[2.0, 1.5, 1.25])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        panorama.render_equirect_panorama(np.asarray(b.triangles), [2.0, 1.5, 1.25], 16, 8)


# ---------------------------------------------------------------------------
# Muxers and the H.264 shim
# ---------------------------------------------------------------------------


def _frames(n=12, h=72, w=96):
    """Moving gradient + box: enough structure for PSNR to be meaningful."""
    out = []
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        f = np.zeros((h, w, 3), np.uint8)
        f[..., 0] = (xx * 255 // w).astype(np.uint8)
        f[..., 1] = (yy * 255 // h).astype(np.uint8)
        x0 = 4 + 6 * i
        f[20:44, x0 : x0 + 16, 2] = 230
        out.append(f)
    return out


@pytest.mark.parametrize("fps,quality,as_pil", [(10, 85, False), (8, 60, True), (25, 95, False)])
def test_mjpeg_muxers_write_the_reference_bytes(tmp_path, fps, quality, as_pil):
    frames = _frames(n=7)
    if as_pil:
        frames = [Image.fromarray(f).convert("RGBA") for f in frames]
    write_mjpeg_avi(tmp_path / "got.avi", frames, fps, quality=quality)
    jax_avi(tmp_path / "want.avi", frames, fps, quality=quality)
    write_mjpeg_mp4(tmp_path / "got.mp4", frames, fps, quality=quality)
    jax_mp4(tmp_path / "want.mp4", frames, fps, quality=quality)
    for ext in ("avi", "mp4"):
        assert (tmp_path / f"got.{ext}").read_bytes() == (tmp_path / f"want.{ext}").read_bytes()
    assert read_avi_frame_count(tmp_path / "got.avi") == 7 == mp4_sample_count(tmp_path / "got.mp4")
    with pytest.raises(ValueError, match="No frames"):
        write_mjpeg_avi(tmp_path / "x.avi", [], fps)
    with pytest.raises(ValueError, match="Frame size"):
        write_mjpeg_mp4(tmp_path / "x.mp4", [frames[0], np.zeros((8, 8, 3), np.uint8)], fps)


@pytest.fixture
def shim():
    if not h264.h264_available():
        pytest.skip("native H.264 shim unavailable")
    return h264


def test_h264_roundtrip(shim, tmp_path):
    frames = _frames()
    path = shim.write_h264_mp4(tmp_path / "clip.mp4", frames, fps=10, crf=18)
    raw = path.read_bytes()
    assert b"avc1" in raw or b"avcC" in raw
    assert b"mp4v" not in raw
    it, w, h, fps = shim.read_video_frames(path)
    decoded = list(it)
    assert (w, h) == (96, 72)
    assert abs(fps - 10.0) < 1.5
    assert len(decoded) == len(frames)
    for src, dec in zip(frames, decoded):
        err = np.mean((src.astype(np.float64) - dec.astype(np.float64)) ** 2)
        assert 10 * np.log10(255.0**2 / max(err, 1e-9)) > 30.0


def test_h264_odd_dimensions_padded(shim, tmp_path):
    frames = [np.full((31, 45, 3), 128, np.uint8) for _ in range(3)]
    path = shim.write_h264_mp4(tmp_path / "odd.mp4", frames, fps=5)
    it, w, h, _ = shim.read_video_frames(path)
    assert (w, h) == (46, 32)
    assert len(list(it)) == 3


@pytest.mark.parametrize("container", ["mp4", "avi"])
def test_reader_decodes_own_mjpeg(shim, tmp_path, container):
    frames = _frames(n=5)
    writer = write_mjpeg_mp4 if container == "mp4" else write_mjpeg_avi
    path = writer(tmp_path / f"mj.{container}", frames, fps=8)
    it, w, h, _ = shim.read_video_frames(path)
    decoded = list(it)
    assert (w, h) == (96, 72)
    assert len(decoded) == 5
    err = np.mean((frames[0].astype(np.float64) - decoded[0].astype(np.float64)) ** 2)
    assert 10 * np.log10(255.0**2 / max(err, 1e-9)) > 25.0


def test_shim_is_built_from_the_port_copy():
    """The port builds its own copy of the shim (its C body the JAX
    package's line for line) into its _build directory."""
    body = lambda p: p.read_text()[p.read_text().index("#include"):]  # noqa: E731
    assert body(h264.SRC) == body(REPO / "cpp/h264mux.c")
    assert h264.lib_path().parent.parent == REPO / "audiblelight_tpu_torch/_build"


# ---------------------------------------------------------------------------
# Event images and the scene video
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fg(tmp_path_factory):
    root = tmp_path_factory.mktemp("fg")
    for wav in sorted((REPO / "tests/resources/soundevents").rglob("*.wav")):
        (root / wav.parent.name).mkdir(parents=True, exist_ok=True)
        shutil.copy(wav, root / wav.parent.name / wav.name)
    return root


def _image_scenes(scene_cls, seed_everything, fg, **device):
    seed_everything(4)
    scene = scene_cls(duration=10.0, sample_rate=SR, backend="shoebox", fg_path=fg,
                      image_path=REPO / "tests/resources/images", max_overlap=3,
                      backend_kwargs=dict(dimensions=[6.0, 5.0, 3.0], max_order=1, max_ir_length=0.05, seed=2),
                      **device)
    scene.add_microphone(microphone_type="ambeovr")
    for _ in range(6):
        try:
            scene.add_event(event_type="static", max_place_attempts=100)
        except ValueError:
            pass
    return scene


def test_event_images_match_the_reference(fg, tmp_path):
    got = _image_scenes(PortScene, tutils.seed_everything, fg, device="cpu")
    want = _image_scenes(JaxScene, jutils.seed_everything, fg)
    assert [Path(p).name for p in got.fg_images] == [Path(p).name for p in want.fg_images]
    picks = [(e.class_label, e.image_filepath) for e in got.get_events()]
    assert picks == [(e.class_label, e.image_filepath) for e in want.get_events()]
    assert any(p is not None for _, p in picks) and any(p is None for _, p in picks)
    for eg, ew in zip(got.get_events(), want.get_events()):
        if eg.image_filepath is not None:
            assert eg.image_filepath.parent.name == eg.class_label
            np.testing.assert_array_equal(eg.load_image(), ew.load_image())
            assert eg.is_image_loaded and eg.load_image() is eg.image
    d = got.to_dict()
    assert [e["image_filepath"] for e in d["events"].values()] == \
           [e["image_filepath"] for e in want.to_dict()["events"].values()]
    back = PortScene.from_dict(json.loads(json.dumps(d)), device="cpu")
    assert [e.image_filepath for e in back.get_events()] == [e.image_filepath for e in got.get_events()]


def test_event_image_filepath_is_validated(fg, tmp_path):
    scene = PortScene(duration=6.0, sample_rate=SR, backend="shoebox", fg_path=fg, device="cpu",
                      backend_kwargs=dict(max_order=1, max_ir_length=0.05, seed=1))
    scene.add_microphone(microphone_type="ambeovr")
    bad = tmp_path / "picture.txt"
    bad.write_text("not an image")
    with pytest.raises(ValueError, match="Extension must be one of"):
        scene.add_event(event_type="static", image_filepath=bad)
    with pytest.raises(ValueError, match="Extension must be one of"):
        scene.add_event(event_type="predefined", trajectory=np.array([[2.0, 2.0, 1.5], [2.5, 2.0, 1.5]]),
                        image_filepath=bad)
    jpg = REPO / "tests/resources/images/telephone/12_0.jpg"
    ev = scene.add_event(event_type="static", image_filepath=jpg, max_place_attempts=100)
    assert ev.image_filepath == jpg and ev.load_image().shape[2] == 3
    with pytest.raises(FileNotFoundError):
        scene.add_event(event_type="static", image_filepath=tmp_path / "missing.jpg")


@pytest.fixture(scope="module")
def video_scenes(fg, tmp_path_factory):
    """A 5 s rlr scene in a small nonconvex room, with one event image, in
    both packages from the same seeds."""
    obj = save_obj(scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0),
                   tmp_path_factory.mktemp("room") / "room.obj")
    jpg = REPO / "tests/resources/images/femaleSpeech/21_0.jpg"

    def build(scene_cls, seed_everything, **device):
        seed_everything(7)
        scene = scene_cls(duration=5.0, sample_rate=SR, backend="rlr", fg_path=fg, max_overlap=2,
                          backend_kwargs=dict(mesh=str(obj), seed=11,
                                              rlr_kwargs=dict(indirect_ray_count=64, indirect_ray_depth=4,
                                                              max_ir_length=0.1, mesh_simplification=True)),
                          **device)
        scene.add_microphone(microphone_type="ambeovr")
        scene.add_event(event_type="static", image_filepath=jpg, max_place_attempts=100)
        scene.add_event(event_type="moving", max_place_attempts=100)
        return scene

    return build(PortScene, tutils.seed_everything, device="cpu"), build(JaxScene, jutils.seed_everything)


def test_scene_video_matches_the_reference(video_scenes, tmp_path, monkeypatch):
    """The port's panorama of the scene against the reference's (as above);
    then, given that background, both packages write the same AVI and GIF
    bytes and MP4 frames: 50 frames, the event image pasted, the moving
    event interpolated; a non-rlr scene raises the reference's error."""
    got, want = video_scenes
    pano = synthesize.scene_panorama(got)
    cam = got.state.microphones["mic000"].coordinates_absolute.mean(axis=0)
    held = _hold_panorama(got.state.mesh.triangles, cam, 640, 320)
    np.testing.assert_array_equal(pano, held)

    monkeypatch.setattr(jviz, "render_equirect_panorama", lambda *a, **k: pano)
    (tmp_path / "got").mkdir()
    (tmp_path / "want").mkdir()
    got.generate(output_dir=tmp_path / "got", audio=False, metadata_json=False, metadata_dcase=False, video=True,
                 video_fname="clip")
    want.generate(output_dir=tmp_path / "want", audio=False, metadata_json=False, metadata_dcase=False, video=True,
                  video_fname="clip")
    names = sorted(p.name for p in (tmp_path / "got").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "want").iterdir()) == ["clip.avi", "clip.gif", "clip.mp4"]
    for name in ("clip.avi", "clip.gif"):
        assert (tmp_path / "got" / name).read_bytes() == (tmp_path / "want" / name).read_bytes(), name
    assert read_avi_frame_count(tmp_path / "got/clip.avi") == 50 == gif_frame_count(tmp_path / "got/clip.gif")
    assert mp4_sample_count(tmp_path / "got/clip.mp4") == 50 == mp4_sample_count(tmp_path / "want/clip.mp4")
    with Image.open(io.BytesIO((tmp_path / "got/clip.gif").read_bytes())) as first:
        assert first.size == (640, 320)

    sb = PortScene(duration=5.0, sample_rate=SR, backend="shoebox", device="cpu",
                   backend_kwargs=dict(max_order=1, max_ir_length=0.05, seed=1))
    sb.add_microphone(microphone_type="ambeovr")
    with pytest.raises(ValueError, match="only supported for the RLR"):
        synthesize.generate_scene_video_from_events(sb, tmp_path / "x")
