"""The port's glTF reader (audiblelight_tpu_torch/io/gltf.py), `load_mesh` on
.glb files and the mesh repair of `TriMesh`, against the JAX package's.

- Hand-packed GLBs, built as the reference's tests build them (a plain
  round trip, an exporter's quirks: an interleaved vertex buffer, uint16
  indices, two nodes one under a TRS transform; a millimetre-authored room;
  a textured quad with UVs and a PNG texture; a .gltf with a data URI and a
  matrix node) load to the reference's vertices, faces, metadata and
  visuals, exactly.
- `remove_degenerate_faces`, `fix_winding`, `repair` and `broken_faces` give
  the reference's faces (order and flips) on meshes with flipped,
  degenerate and missing faces; the world state's `repair_threshold`
  repairs as the reference's does.
"""

import base64
import io
import json
import struct

import numpy as np
import pytest

from audiblelight_tpu.geometry import mesh as jmesh
from audiblelight_tpu.io import gltf as jgltf
from audiblelight_tpu_torch.geometry import mesh as tmesh
from audiblelight_tpu_torch.io import gltf as tgltf


def _pack_glb(gltf: dict, blob: bytes) -> bytes:
    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    blob = blob + b"\x00" * (-len(blob) % 4)
    out = struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob))
    out += struct.pack("<II", len(js), 0x4E4F534A) + js
    return out + struct.pack("<II", len(blob), 0x004E4942) + blob


def _simple_gltf(verts: np.ndarray, faces: np.ndarray) -> tuple:
    blob = verts.tobytes() + faces.tobytes()
    return {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1, "mode": 4}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(verts), "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": faces.size, "type": "SCALAR"},
        ],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": verts.nbytes},
                        {"buffer": 0, "byteOffset": verts.nbytes, "byteLength": faces.nbytes}],
        "buffers": [{"byteLength": len(blob)}],
    }, blob


def _roundtrip(path):
    room = tmesh.scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=1, seed=0)
    path.write_bytes(_pack_glb(*_simple_gltf(room.vertices.astype(np.float32), room.faces.astype(np.uint32))))


def _quirks(path):
    pos_a = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    inter = np.concatenate([pos_a, np.tile(np.array([[0, 0, 1]], np.float32), (3, 1))], axis=1)
    idx_a = np.array([0, 1, 2], np.uint16)
    pos_b = np.array([[0, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    idx_b = np.array([0, 1, 2], np.uint16)
    blob = inter.tobytes() + idx_a.tobytes() + pos_b.tobytes() + idx_b.tobytes()
    o1 = inter.nbytes
    o2 = o1 + idx_a.nbytes
    o3 = o2 + pos_b.nbytes
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0, 1]}],
        "nodes": [{"mesh": 0}, {"mesh": 1, "translation": [5.0, 0.0, 0.0], "scale": [2.0, 2.0, 2.0],
                                "rotation": [0.0, 0.0, 0.38268343, 0.92387953]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2}]},
                   {"primitives": [{"attributes": {"POSITION": 3}, "indices": 4}]}],
        "accessors": [
            {"bufferView": 0, "byteOffset": 0, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3, "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5126, "count": 3, "type": "VEC3"},
            {"bufferView": 3, "componentType": 5123, "count": 3, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": inter.nbytes, "byteStride": 24},
            {"buffer": 0, "byteOffset": o1, "byteLength": idx_a.nbytes},
            {"buffer": 0, "byteOffset": o2, "byteLength": pos_b.nbytes},
            {"buffer": 0, "byteOffset": o3, "byteLength": idx_b.nbytes},
        ],
        "buffers": [{"byteLength": len(blob)}],
    }
    path.write_bytes(_pack_glb(gltf, blob))


def _millimetres(path):
    room = tmesh.box_mesh(extents=[7000.0, 5000.0, 3000.0], center=[3500, 2500, 1500])
    path.write_bytes(_pack_glb(*_simple_gltf(room.vertices.astype(np.float32), room.faces.astype(np.uint32))))


def _centimetres(path):
    """200 units across: a glTF's units are metres, so it is not rescaled."""
    room = tmesh.box_mesh(extents=[200.0, 150.0, 30.0], center=[100, 75, 15])
    path.write_bytes(_pack_glb(*_simple_gltf(room.vertices.astype(np.float32), room.faces.astype(np.uint32))))


def _textured(path):
    from PIL import Image

    verts = np.array([[2, -2, -2], [2, 2, -2], [2, 2, 2], [2, -2, 2]], dtype=np.float32)
    uvs = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], dtype=np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], dtype=np.uint16)
    tex = np.array([[[255, 0, 0], [0, 255, 0]], [[0, 0, 255], [255, 255, 0]]], np.uint8)
    png = io.BytesIO()
    Image.fromarray(np.kron(tex, np.ones((8, 8, 1), np.uint8))).save(png, "PNG")
    png_bytes = png.getvalue()

    def pad4(b):
        return b + b"\x00" * (-len(b) % 4)

    v_b, u_b, i_b, p_b = verts.tobytes(), uvs.tobytes(), pad4(idx.tobytes()), pad4(png_bytes)
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2, "material": 0}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0},
                                                "baseColorFactor": [0.5, 0.25, 1.0, 1.0]}}],
        "textures": [{"source": 0}],
        "images": [{"bufferView": 3, "mimeType": "image/png"}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(v_b)},
            {"buffer": 0, "byteOffset": len(v_b), "byteLength": len(u_b)},
            {"buffer": 0, "byteOffset": len(v_b) + len(u_b), "byteLength": len(idx.tobytes())},
            {"buffer": 0, "byteOffset": len(v_b) + len(u_b) + len(i_b), "byteLength": len(png_bytes)},
        ],
        "buffers": [{"byteLength": len(v_b + u_b + i_b + p_b)}],
    }
    path.write_bytes(_pack_glb(gltf, v_b + u_b + i_b + p_b))


def _gltf_data_uri(path):
    """A .gltf JSON with its buffer as a data URI and a matrix node under a parent."""
    room = tmesh.box_mesh(extents=[3.0, 2.0, 2.5], center=[1.5, 1.0, 1.25])
    gltf, blob = _simple_gltf(room.vertices.astype(np.float32), room.faces.astype(np.uint32))
    gltf["buffers"] = [{"byteLength": len(blob),
                        "uri": "data:application/octet-stream;base64," + base64.b64encode(blob).decode()}]
    matrix = np.eye(4)
    matrix[:3, 3] = [0.5, -1.0, 2.0]
    gltf["nodes"] = [{"children": [1], "translation": [1.0, 0.0, 0.0]},
                     {"mesh": 0, "matrix": matrix.T.ravel().tolist()}]
    path.with_suffix(".gltf").write_text(json.dumps(gltf))


FILES = {"roundtrip.glb": _roundtrip, "quirks.glb": _quirks, "millimetres.glb": _millimetres,
         "centimetres.glb": _centimetres, "textured.glb": _textured, "data_uri.gltf": _gltf_data_uri}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("gltf")
    for name, make in FILES.items():
        make(root / name)
    return root


@pytest.mark.parametrize("name", list(FILES))
def test_load_gltf_matches_reference(files, name):
    path = files / name
    got_v, got_f, got_vis = tgltf.load_gltf(path, with_visuals=True)
    want_v, want_f, want_vis = jgltf.load_gltf(path, with_visuals=True)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_f, want_f)
    assert got_v.dtype == want_v.dtype and got_f.dtype == want_f.dtype
    assert (got_vis is None) == (want_vis is None)
    if want_vis is not None:
        for field in ("face_uv", "face_texture", "face_color"):
            np.testing.assert_array_equal(getattr(got_vis, field), getattr(want_vis, field))
        assert len(got_vis.textures) == len(want_vis.textures)
        for a, b in zip(got_vis.textures, want_vis.textures):
            np.testing.assert_array_equal(a, b)
        assert got_vis.any_textured == want_vis.any_textured
    v2, f2 = tgltf.load_gltf(path)
    np.testing.assert_array_equal(v2, want_v)
    np.testing.assert_array_equal(f2, want_f)


@pytest.mark.parametrize("name", list(FILES))
def test_load_mesh_glb_matches_reference(files, name):
    """load_mesh: the same vertices (units rule included), faces, metadata and visuals."""
    got, want = tmesh.load_mesh(files / name), jmesh.load_mesh(files / name)
    np.testing.assert_array_equal(got.vertices, want.vertices)
    np.testing.assert_array_equal(got.faces, want.faces)
    assert got.metadata == want.metadata
    assert (got.visuals is None) == (want.visuals is None)
    if name == "millimetres.glb":
        assert np.max(got.bounds[1] - got.bounds[0]) == pytest.approx(7.0)
    if name == "centimetres.glb":
        assert np.max(got.bounds[1] - got.bounds[0]) == pytest.approx(200.0)
    if name == "textured.glb":
        assert got.visuals.any_textured and got.visuals.face_uv.shape == (2, 3, 2)


def test_textures_are_skipped_without_pillow(files, monkeypatch, caplog):
    """Without PIL the geometry loads and textures are skipped with the
    reference's warning."""
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    v, f, vis = tgltf.load_gltf(files / "textured.glb", with_visuals=True)
    want_v, want_f = jgltf.load_gltf(files / "textured.glb")
    np.testing.assert_array_equal(v, want_v)
    np.testing.assert_array_equal(f, want_f)
    assert vis is not None and vis.textures == [] and not vis.any_textured
    assert (vis.face_texture == -1).all()


def _broken(seed: int, n_flip: float, n_degenerate: int, n_drop: int):
    """A scanned-like room with a share of faces flipped, degenerate faces
    inserted (a repeated vertex, collinear vertices) and faces removed."""
    room = tmesh.scanned_like_room((6.0, 4.0, 3.0), subdivision_levels=2, seed=seed)
    rng = np.random.default_rng(seed)
    faces = room.faces.copy()
    flip = rng.random(len(faces)) < n_flip
    faces[flip] = faces[flip][:, ::-1]
    faces = np.delete(faces, rng.choice(len(faces), n_drop, replace=False), axis=0)
    verts = room.vertices
    extra = []
    for i in rng.choice(len(faces), n_degenerate, replace=False):
        a, b, _ = faces[i]
        extra.append([a, a, b])
    # collinear: a vertex at the midpoint of an edge
    a, b, _ = faces[0]
    verts = np.concatenate([verts, 0.5 * (verts[a] + verts[b])[None]])
    extra.append([a, b, len(verts) - 1])
    faces = np.concatenate([faces, np.array(extra, dtype=np.int32)])
    faces = faces[rng.permutation(len(faces))]
    return verts, faces


@pytest.mark.parametrize("seed,flip,degenerate,drop", [(0, 0.1, 5, 0), (1, 0.4, 0, 3), (2, 0.0, 12, 7)])
def test_repair_matches_reference(seed, flip, degenerate, drop):
    verts, faces = _broken(seed, flip, degenerate, drop)
    pairs = [(tmesh.TriMesh(verts, faces.copy()), jmesh.TriMesh(verts, faces.copy())) for _ in range(4)]
    (a, b), (c, d), (e, g), (h, k) = pairs
    np.testing.assert_array_equal(a.broken_faces(), b.broken_faces())
    assert a.remove_degenerate_faces() == b.remove_degenerate_faces()
    np.testing.assert_array_equal(a.faces, b.faces)
    c.fix_winding()
    d.fix_winding()
    np.testing.assert_array_equal(c.faces, d.faces)
    e.repair()
    g.repair()
    np.testing.assert_array_equal(e.faces, g.faces)
    np.testing.assert_array_equal(e.broken_faces(), g.broken_faces())
    np.testing.assert_array_equal(e.triangles, g.triangles)
    if drop == 0:  # a closed surface: the repair leaves it watertight and coherently wound
        assert e.is_watertight
        f = e.faces
        directed = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        assert len(np.unique(directed, axis=0)) == len(directed)
    # A mesh with nothing to repair is left as it was
    h.faces = tmesh.box_mesh().faces.copy()
    h.vertices, k.vertices = tmesh.box_mesh().vertices, jmesh.box_mesh().vertices
    k.faces = jmesh.box_mesh().faces.copy()
    h.repair()
    k.repair()
    np.testing.assert_array_equal(h.faces, tmesh.box_mesh().faces)
    np.testing.assert_array_equal(h.faces, k.faces)


@pytest.mark.parametrize("threshold", [None, 0.001, 0.5])
def test_worldstate_repair_threshold_matches_reference(threshold):
    """The rlr world state repairs a mesh that is not watertight when its
    share of broken faces is under `repair_threshold`, as the reference's does."""
    from audiblelight_tpu.worldstate.mesh_backend import WorldStateRLR as JaxRLR
    from audiblelight_tpu_torch.worldstate.mesh_backend import WorldStateRLR

    verts, faces = _broken(3, 0.2, 4, 2)
    got = WorldStateRLR(tmesh.TriMesh(verts, faces.copy()), repair_threshold=threshold, seed=1,
                        add_to_context=False, device="cpu")
    want = JaxRLR(jmesh.TriMesh(verts, faces.copy()), repair_threshold=threshold, seed=1, add_to_context=False)
    np.testing.assert_array_equal(got.mesh.faces, want.mesh.faces)
    assert (len(got.mesh.faces) < len(faces)) == (threshold == 0.5)
    assert got.to_dict()["repair_threshold"] == threshold
    np.testing.assert_array_equal(got.device_state.tris.numpy(), got.mesh.triangles.astype(np.float32))
