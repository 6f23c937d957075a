"""The port's HDF5 reader and writer (io/hdf5.py) against h5py.

- Every committed fixture (tests/resources/torch_sofa/, made by its
  make_fixtures.py with h5py) reads to h5py's arrays bit for bit (dtype,
  shape, bytes) and attributes of the same type and value; the digests
  recorded beside the fixtures (for machines without h5py) hold too.
- Files h5py writes here cover what the fixtures do not: groups of up to
  2,000 links at both libvers (several SNODs and B-tree levels; fractal
  heaps with indirect blocks and v2 B-trees with internal nodes), dense
  attributes, continuation blocks, paged fixed-array chunk indexes with
  unwritten chunks, a deep chunk B-tree with shuffle, deflate and
  fletcher32, and a hypothesis sweep over shapes, dtypes and chunk shapes.
- A netCDF-4 file's DIMENSION_LIST and REFERENCE_LIST raise only when read;
  an extensible-array or v2-B-tree chunk index, SZIP-like unknown filters
  and a corrupted checksum raise by name, never a partial array.
- The writer's files read in h5py to the names, arrays and `str`
  attributes of the reference writers' files on the same inputs, with 9
  and more root entries.
"""

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from audiblelight_tpu.io.sofa import write_sofa as jax_write_sofa
from audiblelight_tpu.rir.hrtf import write_hrtf_sofa as jax_write_hrtf_sofa
from audiblelight_tpu_torch.io import hdf5
from audiblelight_tpu_torch.io.sofa import SOFAFile, write_sofa
from audiblelight_tpu_torch.rir.hrtf import write_hrtf_sofa

FIXTURES = Path(__file__).resolve().parent / "resources" / "torch_sofa"
NAMES = ["reference_writer.sofa", "chunked_gzip.sofa", "netcdf_latest.sofa", "unlimited_latest.sofa"]
LAZY = ("DIMENSION_LIST", "REFERENCE_LIST")


def _same_value(got, want) -> bool:
    if type(got) is not type(want):
        return False
    if isinstance(want, np.ndarray):
        return got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()
    if isinstance(want, np.generic):
        return got.dtype == want.dtype and got.tobytes() == want.tobytes()
    return got == want


def _compare(path: Path) -> int:
    """Hold every object of `path` to h5py; return the datasets compared."""
    n = 0
    with h5py.File(path, "r") as ref, hdf5.File(path) as mine:
        assert mine.keys() == sorted(ref.keys())
        pairs = [(ref, mine)]
        ref.visit(lambda name: pairs.append((ref[name], mine[name])))
        for r, m in pairs:
            assert sorted(m.attrs) == sorted(r.attrs), r.name
            for k in r.attrs:
                if k in LAZY:
                    with pytest.raises(NotImplementedError, match="not supported by the port's SOFA reader"):
                        m.attrs[k]
                    continue
                assert _same_value(m.attrs[k], r.attrs[k]), (r.name, k, m.attrs[k], r.attrs[k])
            if isinstance(r, h5py.Dataset):
                assert m.shape == r.shape and m.dtype == r.dtype
                want = r[()]
                got = m[()]
                assert _same_value(got, want), r.name
                if r.ndim and r.shape[0] > 2:
                    assert _same_value(m[1], r[1]) and _same_value(m[[0, 2]], r[[0, 2]])
                    assert _same_value(m[1:3, ...], r[1:3, ...])
                n += 1
    return n


@pytest.mark.parametrize("name", NAMES[:3])
def test_fixture_reads_as_h5py(name):
    assert _compare(FIXTURES / name) >= 8


def test_fixture_digests():
    """The recorded digests (what the card checks without h5py) hold."""
    record = json.loads((FIXTURES / "digests.json").read_text())
    assert sorted(record) == sorted(NAMES)
    for name, rec in record.items():
        with hdf5.File(FIXTURES / name) as f:
            for ds, d in rec["datasets"].items():
                arr = f[ds][()]
                assert arr.dtype.str == d["dtype"] and list(arr.shape) == d["shape"]
                assert hashlib.sha256(arr.tobytes()).hexdigest() == d["sha256"], (name, ds)
            for ds, feature in rec["refused"].items():
                with pytest.raises(NotImplementedError, match=f"HDF5 {feature} is not supported"):
                    f[ds][()]


def test_unlimited_datasets_are_refused_by_name():
    """libver="latest" indexes one unlimited axis with an extensible array and
    two with a v2 B-tree: the file opens, the other datasets read, and those
    two raise by name when read. h5py's default libver indexes the same
    unlimited dataset with a v1 B-tree, which reads."""
    path = FIXTURES / "unlimited_latest.sofa"
    with h5py.File(path, "r") as ref, hdf5.File(path) as mine:
        assert mine.keys() == ["Both", "Data.IR", "Data.SamplingRate"]
        assert mine["Data.IR"].shape == (4, 2, 8) and mine["Data.IR"].maxshape == (None, 2, 8)
        np.testing.assert_array_equal(mine["Data.SamplingRate"][()], ref["Data.SamplingRate"][()])
        with pytest.raises(NotImplementedError, match="HDF5 extensible-array chunk index is not supported"):
            mine["Data.IR"][()]
        with pytest.raises(NotImplementedError, match="HDF5 v2-B-tree chunk index is not supported"):
            np.asarray(mine["Both"])
    with hdf5.File(FIXTURES / "chunked_gzip.sofa") as f:
        assert f["Growing"].maxshape == (None, 3) and f["Growing"].layout == "chunked"


@pytest.mark.parametrize("libver,n", [("earliest", 9), ("earliest", 300), ("earliest", 2000),
                                      ("latest", 9), ("latest", 300), ("latest", 2000)])
def test_big_groups_and_dense_attributes(tmp_path, libver, n):
    path = tmp_path / "big.h5"
    with h5py.File(path, "w", libver=libver) as f:
        for i in range(n):
            f.create_dataset(f"d{i:05d}_" + "x" * (i % 37), data=np.array([float(i)]))
        for i in range(min(n, 300)):
            f.attrs[f"attr{i:04d}" + "y" * (i % 50)] = f"value {i}"
        first = f["d00000_"]
        for i in range(30):  # added after the datasets: continuation blocks
            first.attrs[f"late{i}"] = np.arange(i + 1, dtype=">i4")
    with h5py.File(path, "r") as ref, hdf5.File(path) as mine:
        assert mine.keys() == sorted(ref.keys()) and len(mine) == n
        for k in list(ref.keys())[::97]:
            assert _same_value(mine[k][()], ref[k][()])
        assert dict(mine.attrs.items()) == dict(ref.attrs)
        ra, ma = ref["d00000_"].attrs, mine["d00000_"].attrs
        assert sorted(ma) == sorted(ra) and all(_same_value(ma[k], ra[k]) for k in ra)


@pytest.mark.parametrize("compression", [None, "gzip"])
def test_paged_fixed_array_and_unwritten_chunks(tmp_path, compression):
    """More chunks than one fixed-array page (1,024), some never written."""
    path = tmp_path / "paged.h5"
    data = np.random.default_rng(0).standard_normal((3000, 4)).astype(">f4")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=data, chunks=(2, 4), compression=compression)
        d = f.create_dataset("sparse", shape=(3000, 4), chunks=(2, 2), dtype="<i8", fillvalue=7,
                             compression=compression)
        d[100:110] = 3
        d[2500:2501, :1] = 9
    assert _compare(path) == 2


def test_deep_chunk_btree_with_filters(tmp_path):
    path = tmp_path / "deep.h5"
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.arange(20000, dtype="<u2").reshape(5000, 4), chunks=(3, 4),
                         compression="gzip", shuffle=True, fletcher32=True)
        d = f.create_dataset("s", shape=(500, 500), chunks=(10, 10), dtype="f8", fillvalue=np.nan)
        d[5:27, 300:301] = 1.0
    assert _compare(path) == 2


DTYPES = ["<f4", ">f4", "<f8", ">f8", "<i1", "<u1", "<i2", ">u2", "<i4", ">i4", "<u8", ">i8", "<f2"]


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(shape=st.lists(st.integers(1, 9), min_size=1, max_size=3), dtype=st.sampled_from(DTYPES),
       chunked=st.booleans(), filters=st.sampled_from([(), ("gzip",), ("gzip", "shuffle"), ("fletcher32",)]),
       libver=st.sampled_from(["earliest", "latest"]), data=st.data())
def test_datasets_read_as_h5py(tmp_path_factory, shape, dtype, chunked, filters, libver, data):
    chunks = tuple(data.draw(st.integers(1, s)) for s in shape) if chunked or filters else None
    arr = (np.random.default_rng(len(shape)).standard_normal(shape) * 50).astype(dtype)
    path = tmp_path_factory.mktemp("hyp") / "x.h5"
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", data=arr, chunks=chunks, compression="gzip" if "gzip" in filters else None,
                         shuffle="shuffle" in filters, fletcher32="fletcher32" in filters)
    assert _compare(path) == 1


def test_netcdf_attributes_decode_on_demand():
    """DIMENSION_LIST (variable-length references) and REFERENCE_LIST
    (compounds) raise only when asked for; the file and the rest read."""
    with hdf5.File(FIXTURES / "netcdf_latest.sofa") as f:
        ir = f["Data.IR"]
        assert "DIMENSION_LIST" in ir.attrs and ir.shape == (24, 2, 64)
        with pytest.raises(NotImplementedError, match="variable-length sequence datatype"):
            ir.attrs["DIMENSION_LIST"]
        with pytest.raises(NotImplementedError, match="compound datatype"):
            f["M"].attrs["REFERENCE_LIST"]
        assert f["M"].attrs["CLASS"] == b"DIMENSION_SCALE"
        assert SOFAFile(FIXTURES / "netcdf_latest.sofa").get_global_attributes()["SOFAConventions"] == \
            "SimpleFreeFieldHRIR"


def test_corruption_and_unknown_filters_raise(tmp_path):
    """A flipped byte in a v2 object header fails its checksum; a filter the
    reader does not decode raises by name when the dataset is read."""
    path = tmp_path / "v2.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.arange(4.0))
    raw = bytearray(path.read_bytes())
    at = raw.index(b"OHDR", raw.index(b"OHDR") + 4)  # the dataset's header
    raw[at + 24] ^= 0xFF
    (tmp_path / "bad.h5").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        with hdf5.File(tmp_path / "bad.h5") as f:
            f["x"][()]
    with pytest.raises(NotImplementedError, match="HDF5 N-bit filter is not supported"):
        hdf5._apply_filter((5, ()), b"", 4)
    assert hdf5.fletcher32(b"abcde") == 0x4FF029C7  # big-endian words, the odd byte high


def _h5py_view(path):
    with h5py.File(path, "r") as f:
        out = {k: (f[k].dtype.str, f[k].shape, f[k][()].tobytes(), dict(f[k].attrs)) for k in f}
        return out, dict(f.attrs)


def test_write_sofa_reads_as_the_reference_writers(tmp_path):
    rng = np.random.default_rng(0)
    args = (rng.standard_normal((5, 4, 33)), rng.uniform(0, 3, (5, 3)), [1.0, 2.0, 1.5],
            rng.uniform(-0.02, 0.02, (4, 3)), 48000)
    for kw in ({}, dict(listener_short_name="foa", conventions="GeneralFIR",
                        extra_attrs={"Comment": "measured", "RoomType": "reverberant", "Title2": "x"})):
        jax_write_sofa(tmp_path / "ref.sofa", *args, **kw)
        write_sofa(tmp_path / "port.sofa", *args, **kw)
        got, want = _h5py_view(tmp_path / "port.sofa"), _h5py_view(tmp_path / "ref.sofa")
        assert got == want and all(type(v) is str for v in got[1].values())
        assert len(got[0]) == 8 and len(got[1]) >= 6


def test_write_hrtf_sofa_reads_as_the_reference_writer(tmp_path):
    rng = np.random.default_rng(1)
    args = (rng.standard_normal((7, 2, 21)), rng.uniform(0, 360, 7), rng.uniform(-40, 80, 7), 44100)
    jax_write_hrtf_sofa(tmp_path / "ref.sofa", *args)
    write_hrtf_sofa(tmp_path / "port.sofa", *args)
    got, want = _h5py_view(tmp_path / "port.sofa"), _h5py_view(tmp_path / "ref.sofa")
    assert got == want and type(got[0]["SourcePosition"][3]["Units"]) is str


@pytest.mark.parametrize("n", [0, 9, 25])
def test_writer_with_more_entries_than_one_node(tmp_path, n):
    """A ninth root entry and beyond: one symbol-table node of a larger
    group leaf K, which h5py and the reader read."""
    ds = {f"v{i}.name": np.random.default_rng(i).standard_normal((i % 3 + 1, 2)) for i in range(n)}
    ds["scalar"], ds["empty"] = np.array(3.0), np.zeros((0, 3))
    attrs = {"Conventions": "SOFA", "Title": "ünïcode ✓", "Empty": ""}
    hdf5.write_file(tmp_path / "w.h5", ds, attrs, {"scalar": {"Units": "metre"}})
    with h5py.File(tmp_path / "w.h5", "r") as f:
        assert sorted(f.keys()) == sorted(ds) and dict(f.attrs) == attrs
        for k, v in ds.items():
            assert f[k].dtype == np.dtype("<f8") and f[k].shape == np.shape(v)
            np.testing.assert_array_equal(f[k][()], v)
        assert dict(f["scalar"].attrs) == {"Units": "metre"}
    assert _compare(tmp_path / "w.h5") == len(ds)
    with pytest.raises(TypeError, match="str values only"):
        hdf5.write_file(tmp_path / "x.h5", {"a": np.zeros(2)}, {"n": 3})


NO_H5PY = """
import sys
sys.modules["h5py"] = None
from audiblelight_tpu_torch.io.sofa import SOFAFile
from audiblelight_tpu_torch.rir.hrtf import read_hrtf_sofa
from audiblelight_tpu_torch.worldstate.sofa_backend import WorldStateSOFA
try:
    import h5py
    raise SystemExit("h5py imported")
except ImportError:
    pass
fix = sys.argv[1]
with SOFAFile(fix + "/reference_writer.sofa") as f:
    assert f.is_valid() and f.data_ir.shape == (12, 4, 96) and f.sampling_rate == 24000.0
dirs, hrirs = read_hrtf_sofa(fix + "/netcdf_latest.sofa", 24000)
assert dirs.shape == (24, 3) and hrirs.shape[:2] == (24, 2)
state = WorldStateSOFA(fix + "/reference_writer.sofa", sample_rate=24000, seed=1, device="cpu")
state.add_emitters(n_emitters=2)
assert state.get_irs()["mic000"].shape == (4, 2, 96)
assert not any(m == "h5py" or m.startswith(("jax", "audiblelight_tpu.")) for m in sys.modules if sys.modules[m])
print("read without h5py")
"""


def test_no_h5py():
    """With h5py unimportable (a fresh process), the port imports and reads
    a SOFA file and an HRTF set, and imports neither JAX nor the JAX package."""
    out = subprocess.run([sys.executable, "-c", NO_H5PY, str(FIXTURES)], capture_output=True, text=True,
                         cwd=FIXTURES.parents[2], timeout=120)
    assert out.returncode == 0 and "read without h5py" in out.stdout, out.stderr[-2000:]
