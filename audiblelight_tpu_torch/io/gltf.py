"""Minimal GLB/glTF-2.0 mesh reader (host side, pure numpy).

The port's copy of audiblelight_tpu/io/gltf.py, with the same results: the
binary container or the JSON file with its buffers (embedded, data URIs or
files beside it), accessors (strided ones too), the default scene's node
hierarchy with its transforms (matrix or TRS), one concatenated triangle
soup (vertices + faces) and, with `with_visuals=True`, the material layer:
per-face TEXCOORD_0 UVs, base-colour textures decoded through PIL where
PIL is installed (skipped with a warning where it is not: geometry never
depends on textures) and base-colour factors. Per the glTF 2.0 spec, units
are metres.
"""

from __future__ import annotations

import base64
import json
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np


@dataclass
class MeshVisuals:
    """Per-face material data for texture-mapped rendering.

    face_uv: (F, 3, 2) texture coordinates per face corner (zeros if absent).
    face_texture: (F,) int32 index into `textures`; -1 = untextured face.
    face_color: (F, 3) float32 linear base-color factor (defaults to 1).
    textures: decoded (H, W, 3) uint8 RGB images.
    """

    face_uv: np.ndarray
    face_texture: np.ndarray
    face_color: np.ndarray
    textures: list = field(default_factory=list)

    @property
    def any_textured(self) -> bool:
        return len(self.textures) > 0 and bool(np.any(self.face_texture >= 0))

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_SIZES = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _parse_glb_container(data: bytes) -> tuple[dict, bytes]:
    """Split a GLB container into (json_dict, binary_blob)."""
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # b'glTF'
        raise ValueError("Not a GLB file (bad magic)")
    if version != 2:
        raise ValueError(f"Unsupported GLB version: {version}")

    offset = 12
    json_chunk = None
    bin_chunk = b""
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + chunk_len]
        offset += chunk_len
        if chunk_type == 0x4E4F534A:  # JSON
            json_chunk = json.loads(chunk.decode("utf-8"))
        elif chunk_type == 0x004E4942:  # BIN
            bin_chunk = chunk
    if json_chunk is None:
        raise ValueError("GLB file has no JSON chunk")
    return json_chunk, bin_chunk


def _read_accessor(gltf: dict, buffers: list[bytes], accessor_idx: int) -> np.ndarray:
    """Read an accessor into a numpy array of shape (count, type_size)."""
    acc = gltf["accessors"][accessor_idx]
    if "bufferView" not in acc:
        count = acc["count"]
        size = _TYPE_SIZES[acc["type"]]
        return np.zeros((count, size), dtype=_COMPONENT_DTYPES[acc["componentType"]])

    view = gltf["bufferViews"][acc["bufferView"]]
    buffer = buffers[view["buffer"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]]).newbyteorder("<")
    n_comp = _TYPE_SIZES[acc["type"]]
    count = acc["count"]
    item_bytes = dtype.itemsize * n_comp

    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", item_bytes)

    if stride == item_bytes:
        raw = buffer[start : start + count * item_bytes]
        arr = np.frombuffer(raw, dtype=dtype, count=count * n_comp).reshape(count, n_comp)
    else:
        # Interleaved: gather with a strided view over bytes
        raw = np.frombuffer(buffer, dtype=np.uint8)
        idx = start + stride * np.arange(count)[:, None] + np.arange(item_bytes)[None, :]
        arr = raw[idx].copy().view(dtype).reshape(count, n_comp)
    return np.ascontiguousarray(arr)


def _node_transform(node: dict) -> np.ndarray:
    """4x4 world transform for a glTF node (matrix or TRS)."""
    if "matrix" in node:
        return np.asarray(node["matrix"], dtype=np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] *= np.asarray(node["scale"], dtype=np.float64)
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        m[:3, :3] = rot @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _decode_image(gltf: dict, buffers: list, img_idx: int, path: Path):
    """Decode a glTF image (bufferView or URI) to (H, W, 3) uint8 RGB, or
    None when pillow (an optional visualisation dependency) is unavailable —
    texture decode must never block ACOUSTIC use of a scanned mesh."""
    import io as _io

    try:
        from PIL import Image
    except ImportError:
        from audiblelight_tpu_torch.utils import logger

        logger.warning(
            "pillow is not installed: glTF textures are skipped (geometry "
            "loads normally; panoramas fall back to per-face albedo)"
        )
        return None

    img = gltf["images"][img_idx]
    if "bufferView" in img:
        view = gltf["bufferViews"][img["bufferView"]]
        start = view.get("byteOffset", 0)
        raw = buffers[view["buffer"]][start : start + view["byteLength"]]
    else:
        uri = img.get("uri", "")
        if uri.startswith("data:"):
            raw = base64.b64decode(uri.split(",", 1)[1])
        else:
            raw = (path.parent / uri).read_bytes()
    with Image.open(_io.BytesIO(raw)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _prim_material(gltf: dict, prim: dict):
    """(texture_image_index | None, base_color_rgb) for a primitive."""
    mat_idx = prim.get("material")
    if mat_idx is None:
        return None, np.ones(3, dtype=np.float32)
    mat = gltf.get("materials", [])[mat_idx]
    pbr = mat.get("pbrMetallicRoughness", {})
    color = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1])[:3], dtype=np.float32)
    tex = pbr.get("baseColorTexture")
    if tex is None:
        return None, color
    source = gltf.get("textures", [])[tex["index"]].get("source")
    return source, color


def _read_uv(gltf: dict, buffers: list, prim: dict) -> Optional[np.ndarray]:
    """TEXCOORD_0 as float32 in [0, 1] conventions (normalised int support)."""
    acc_idx = prim.get("attributes", {}).get("TEXCOORD_0")
    if acc_idx is None:
        return None
    acc = gltf["accessors"][acc_idx]
    uv = _read_accessor(gltf, buffers, acc_idx).astype(np.float32)
    comp = acc["componentType"]
    if comp == 5121:  # normalised ubyte
        uv = uv / 255.0
    elif comp == 5123:  # normalised ushort
        uv = uv / 65535.0
    return uv


def load_gltf(
    path: Union[str, Path], with_visuals: bool = False
) -> Union[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray, Optional[MeshVisuals]]]:
    """Load a .glb/.gltf file into a single (vertices, faces) triangle soup.

    All mesh primitives in the default scene are concatenated, with node transforms
    applied. Returns float64 vertices (V, 3) and int32 faces (F, 3); with
    `with_visuals=True`, also a MeshVisuals (or None when the file carries no
    material layer).
    """
    path = Path(path)
    data = path.read_bytes()
    if path.suffix.lower() == ".glb" or data[:4] == b"glTF":
        gltf, bin_blob = _parse_glb_container(data)
        buffers = []
        for buf in gltf.get("buffers", []):
            uri = buf.get("uri")
            if uri is None:
                buffers.append(bin_blob)
            elif uri.startswith("data:"):
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                buffers.append((path.parent / uri).read_bytes())
    else:
        gltf = json.loads(data.decode("utf-8"))
        buffers = []
        for buf in gltf.get("buffers", []):
            uri = buf.get("uri", "")
            if uri.startswith("data:"):
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                buffers.append((path.parent / uri).read_bytes())

    all_verts = []
    all_faces = []
    vis_uv = []  # per-prim (F_p, 3, 2)
    vis_tex = []  # per-prim (F_p,) texture index (-1 = none)
    vis_color = []  # per-prim (F_p, 3)
    image_slots: dict[int, int] = {}  # glTF image idx -> position in `textures`
    textures: list[np.ndarray] = []
    vert_offset = 0

    def process_prim(prim: dict, tf: Optional[np.ndarray]):
        nonlocal vert_offset
        if prim.get("mode", 4) != 4:  # triangles only
            return
        pos = _read_accessor(gltf, buffers, prim["attributes"]["POSITION"]).astype(
            np.float64
        )
        if tf is not None:
            pos_h = np.concatenate([pos, np.ones((len(pos), 1))], axis=1)
            pos = (tf @ pos_h.T).T[:, :3]
        if "indices" in prim:
            idx = _read_accessor(gltf, buffers, prim["indices"]).reshape(-1)
        else:
            idx = np.arange(len(pos))
        local = idx.astype(np.int64).reshape(-1, 3)
        all_verts.append(pos)
        all_faces.append(local + vert_offset)
        vert_offset += len(pos)

        if with_visuals:
            n_f = len(local)
            img_idx, color = _prim_material(gltf, prim)
            uv = _read_uv(gltf, buffers, prim)
            if img_idx is not None and uv is not None:
                if img_idx not in image_slots:
                    decoded = _decode_image(gltf, buffers, img_idx, path)
                    image_slots[img_idx] = len(textures) if decoded is not None else -1
                    if decoded is not None:
                        textures.append(decoded)
                vis_tex.append(np.full(n_f, image_slots[img_idx], dtype=np.int32))
                vis_uv.append(uv[local].astype(np.float32))
            else:
                vis_tex.append(np.full(n_f, -1, dtype=np.int32))
                vis_uv.append(np.zeros((n_f, 3, 2), dtype=np.float32))
            vis_color.append(np.broadcast_to(color, (n_f, 3)).copy())

    # Walk the node hierarchy of the default scene, accumulating transforms.
    scene_idx = gltf.get("scene", 0)
    if "scenes" in gltf:
        scenes = gltf["scenes"]
        root_nodes = scenes[scene_idx].get("nodes", []) if scenes else []
    else:
        # No scene list: roots are the nodes NOT referenced as children —
        # visiting every node would load child meshes twice (once through the
        # parent transform, once untransformed at the origin).
        children = {c for n in gltf.get("nodes", []) for c in n.get("children", [])}
        root_nodes = [i for i in range(len(gltf.get("nodes", []))) if i not in children]
    nodes = gltf.get("nodes", [])

    def visit(node_idx: int, parent_tf: np.ndarray):
        node = nodes[node_idx]
        tf = parent_tf @ _node_transform(node)
        if "mesh" in node:
            for prim in gltf["meshes"][node["mesh"]].get("primitives", []):
                process_prim(prim, tf)
        for child in node.get("children", []):
            visit(child, tf)

    if root_nodes and nodes:
        for root in root_nodes:
            visit(root, np.eye(4))
    else:
        # No scene graph: read all mesh primitives directly
        for mesh in gltf.get("meshes", []):
            for prim in mesh.get("primitives", []):
                process_prim(prim, None)

    if not all_verts:
        raise ValueError(f"No triangle meshes found in {path}")

    vertices = np.concatenate(all_verts, axis=0)
    faces = np.concatenate(all_faces, axis=0).astype(np.int32)
    if not with_visuals:
        return vertices, faces
    visuals = None
    if vis_tex:
        face_texture = np.concatenate(vis_tex)
        if textures or not np.allclose(np.concatenate(vis_color), 1.0):
            visuals = MeshVisuals(
                face_uv=np.concatenate(vis_uv),
                face_texture=face_texture,
                face_color=np.concatenate(vis_color).astype(np.float32),
                textures=textures,
            )
    return vertices, faces, visuals
