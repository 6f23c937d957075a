"""Write the h5py-made SOFA fixtures of this folder and their digests.

Run from the repository root with h5py installed (the JAX package's writer
makes the first file):

    python tests/resources/torch_sofa/make_fixtures.py

Files:
- ``reference_writer.sofa``: `audiblelight_tpu.io.sofa.write_sofa` as-is
  (superblock v0, v1 headers, a root symbol table, contiguous float64,
  variable-length string attributes);
- ``chunked_gzip.sofa``: chunked datasets (v1 B-tree index) through
  shuffle + deflate + fletcher32, fixed-length byte-string attributes, a
  big-endian, an integer, a compact and a never-written (fill value)
  dataset, and an unlimited dataset, which h5py's default libver indexes
  with a v1 B-tree too;
- ``netcdf_latest.sofa``: ``libver="latest"`` with ``track_order=True``, as a
  netCDF-4 SOFA file is laid out: more than 8 links and more than 8 root
  attributes (dense storage: fractal heaps and v2 B-trees), dimension
  scales M, R, N, E, I, C attached (``DIMENSION_LIST``, ``REFERENCE_LIST``),
  fixed-array and single-chunk indexes;
- ``unlimited_latest.sofa``: ``libver="latest"`` with unlimited dimensions:
  an extensible-array index (one unlimited axis) and a v2-B-tree index (two),
  which the port's reader refuses by name.

``digests.json`` records, for every dataset that reads, its dtype, shape and
the sha256 of the bytes h5py returns, and every attribute's value, so that a
machine without h5py can check the port's reader.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import h5py
import numpy as np

HERE = Path(__file__).resolve().parent


def _irs(rng: np.random.Generator, m: int, r: int, n: int) -> np.ndarray:
    decay = np.exp(-np.arange(n) / (n / 6.0))
    return rng.standard_normal((m, r, n)) * decay


def _grid(m: int) -> np.ndarray:
    az = np.linspace(0.0, 2 * np.pi, m, endpoint=False)
    return np.stack([1.5 * np.cos(az), 1.5 * np.sin(az), 0.3 * np.sin(3 * az)], axis=-1)


def reference_writer(path: Path) -> None:
    from audiblelight_tpu.io.sofa import write_sofa

    rng = np.random.default_rng(1)
    capsules = np.array([[0.01, 0.01, 0.01], [0.01, -0.01, -0.01], [-0.01, 0.01, -0.01], [-0.01, -0.01, 0.01]])
    write_sofa(path, _irs(rng, 12, 4, 96), _grid(12), [0.0, 0.0, 0.0], capsules, 24000, listener_short_name="mic")


def chunked_gzip(path: Path) -> None:
    rng = np.random.default_rng(2)
    m, r, n = 20, 2, 100
    with h5py.File(path, "w") as f:
        f.attrs["Conventions"] = np.bytes_("SOFA")
        f.attrs["SOFAConventions"] = np.bytes_("SingleRoomSRIR")
        f.attrs["DataType"] = np.bytes_("FIR")
        f.attrs["ListenerShortName"] = np.bytes_("foa")
        f.attrs["Title"] = np.array([b"chunked", b"fixture"], dtype="S8")
        f.attrs["Version"] = np.float32(2.25)
        f.create_dataset("Data.IR", data=_irs(rng, m, r, n).astype(np.float32), chunks=(7, 2, 32),
                         compression="gzip", compression_opts=6, shuffle=True, fletcher32=True)
        f.create_dataset("Data.SamplingRate", data=np.array([48000.0]))
        sp = f.create_dataset("SourcePosition", data=_grid(m), chunks=(8, 3), compression="gzip", shuffle=True)
        sp.attrs["Type"] = np.bytes_("cartesian")
        sp.attrs["Units"] = np.bytes_("metre")
        f.create_dataset("ListenerPosition", data=np.zeros((1, 3), dtype=">f8"))
        f.create_dataset("ReceiverPosition", data=np.array([[[0.0], [0.09], [0.0]], [[0.0], [-0.09], [0.0]]]))
        f.create_dataset("Counts", data=np.arange(-30, 30, dtype=">i2").reshape(6, 10), chunks=(4, 4),
                         compression="gzip")
        f.create_dataset("Indices", data=np.arange(m, dtype=np.uint32))
        f.create_dataset("Unwritten", shape=(3, 4), dtype=np.float64, fillvalue=-2.5)
        f.create_dataset("Growing", data=np.arange(24.0).reshape(8, 3), maxshape=(None, 3), chunks=(3, 3))
        space = h5py.h5s.create_simple((2, 5))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        dsid = h5py.h5d.create(f.id, b"Compact", h5py.h5t.STD_I32LE, space, dcpl=dcpl)
        dsid.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(10, dtype=np.int32).reshape(2, 5))


def netcdf_latest(path: Path) -> None:
    rng = np.random.default_rng(3)
    m, r, n = 24, 2, 64
    with h5py.File(path, "w", libver="latest", track_order=True) as f:
        for k, v in [("Conventions", "SOFA"), ("Version", "2.1"), ("SOFAConventions", "SimpleFreeFieldHRIR"),
                     ("SOFAConventionsVersion", "1.0"), ("APIName", "netcdf-like"), ("APIVersion", "1.1"),
                     ("ApplicationName", "fixture"), ("AuthorContact", "none"), ("Comment", "dense attrs"),
                     ("DataType", "FIR"), ("History", "made by make_fixtures.py"), ("License", "CC-BY"),
                     ("ListenerShortName", "binaural"), ("Organization", "none"), ("RoomType", "free field"),
                     ("Title", "netcdf-like SOFA")]:
            f.attrs[k] = np.bytes_(v)
        f.attrs["_NCProperties"] = np.bytes_("version=2,netcdf=4.9.2,hdf5=1.14.6")
        f.attrs["Origin"] = "a variable-length str"
        dims = {"M": m, "R": r, "N": n, "E": 1, "I": 1, "C": 3}
        scales = {}
        for name, size in dims.items():
            ds = f.create_dataset(name, data=np.zeros(size, dtype=np.float32))
            ds.make_scale(name)
            ds.attrs["NAME"] = np.bytes_("This is a netCDF dimension but not a netCDF variable.")
            scales[name] = ds
        ir = f.create_dataset("Data.IR", data=_irs(rng, m, r, n), chunks=(8, 2, 16), compression="gzip")
        f.create_dataset("Data.SamplingRate", data=np.array([44100.0]))
        f.create_dataset("Data.Delay", data=np.zeros((1, r)), chunks=(1, r))
        az = np.linspace(0.0, 360.0, m, endpoint=False)
        sp = f.create_dataset("SourcePosition", data=np.stack([az, np.zeros(m), np.full(m, 1.5)], -1),
                              chunks=(m, 3))
        sp.attrs["Type"] = np.bytes_("spherical")
        sp.attrs["Units"] = np.bytes_("degree, degree, metre")
        f.create_dataset("EmitterPosition", data=np.zeros((1, 3, 1)))
        f.create_dataset("ListenerPosition", data=np.zeros((1, 3)))
        f.create_dataset("ReceiverPosition", data=np.array([[[0.0], [0.09], [0.0]], [[0.0], [-0.09], [0.0]]]))
        for axis, name in enumerate("MRN"):
            ir.dims[axis].attach_scale(scales[name])
        sp.dims[0].attach_scale(scales["M"])
        sp.dims[1].attach_scale(scales["C"])


def unlimited_latest(path: Path) -> None:
    with h5py.File(path, "w", libver="latest") as f:
        f.attrs["Conventions"] = "SOFA"
        f.create_dataset("Data.IR", data=np.ones((4, 2, 8)), maxshape=(None, 2, 8), chunks=(2, 2, 8))
        f.create_dataset("Both", data=np.ones((4, 4)), maxshape=(None, None), chunks=(2, 2))
        f.create_dataset("Data.SamplingRate", data=np.array([48000.0]))


def _jsonable(v):
    if isinstance(v, bytes):
        return {"bytes": v.hex()}
    if isinstance(v, str):
        return {"str": v}
    arr = np.asarray(v)
    if arr.dtype.kind == "S":
        return {"bytes_array": [x.hex() for x in arr.ravel().tolist()], "shape": list(arr.shape)}
    return {"dtype": arr.dtype.str, "shape": list(arr.shape), "hex": arr.tobytes().hex()}


def digests(path: Path) -> dict:
    out: dict = {"datasets": {}, "attrs": {}, "refused": {}}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                try:
                    arr = obj[()]
                except Exception as err:  # pragma: no cover
                    out["refused"][name] = str(err)
                    return
                out["datasets"][name] = {"dtype": arr.dtype.str, "shape": list(arr.shape),
                                         "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
            for k in obj.attrs:
                if k in ("DIMENSION_LIST", "REFERENCE_LIST"):
                    continue
                out["attrs"].setdefault(name, {})[k] = _jsonable(obj.attrs[k])
        for k in f.attrs:
            out["attrs"].setdefault("/", {})[k] = _jsonable(f.attrs[k])
        f.visititems(visit)
    return out


FIXTURES = {"reference_writer.sofa": reference_writer, "chunked_gzip.sofa": chunked_gzip,
            "netcdf_latest.sofa": netcdf_latest, "unlimited_latest.sofa": unlimited_latest}
REFUSED = {"unlimited_latest.sofa": {"Data.IR": "extensible-array chunk index", "Both": "v2-B-tree chunk index"}}


def main() -> None:
    record = {}
    for name, make in FIXTURES.items():
        make(HERE / name)
        record[name] = digests(HERE / name)
        for ds, feature in REFUSED.get(name, {}).items():
            record[name]["datasets"].pop(ds, None)
            record[name]["refused"][ds] = feature
    (HERE / "digests.json").write_text(json.dumps(record, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
