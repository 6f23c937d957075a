"""SOFA (Spatially Oriented Format for Acoustics) file I/O on the port's own HDF5 reader.

Counterpart of audiblelight_tpu/io/sofa.py, which reads through h5py: here
`io.hdf5` reads the file, so the SOFA backend and measured HRTFs run where
h5py is not installed. `SOFAFile` gives the variables the SOFA backend needs
(Data.IR, SourcePosition, ListenerPosition, ReceiverPosition,
Data.SamplingRate, the global attributes) as the reference does; `data_ir`
reads the whole IR array, `read_ir_rows` only the measurements asked for.
`write_sofa` writes the reference's SingleRoomSRIR file through
`io.hdf5.write_file`, which h5py reads back as it reads the reference's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

from audiblelight_tpu_torch.io import hdf5


class SOFAFile:
    """Read-only view of a SOFA file's variables and attributes."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._f = hdf5.File(self.path)

    def __enter__(self) -> "SOFAFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._f.close()

    def is_valid(self) -> bool:
        """Minimal validity: IR data and source positions present."""
        try:
            return "Data.IR" in self._f and "SourcePosition" in self._f
        except (ValueError, NotImplementedError):
            return False

    def get_global_attributes(self) -> dict:
        """All root-level global attributes, bytes decoded to str."""
        out = {}
        for k, v in self._f.attrs.items():
            if isinstance(v, bytes):
                v = v.decode("utf-8", errors="replace")
            elif isinstance(v, np.ndarray) and v.dtype.kind in ("S", "U"):
                v = str(v.item()) if v.size == 1 else [str(x) for x in v]
            out[str(k)] = v
        return out

    def get_variable(self, name: str) -> np.ndarray:
        if name not in self._f:
            raise KeyError(f"Variable '{name}' not found in SOFA file {self.path}")
        return np.asarray(self._f[name])

    @property
    def data_ir(self) -> np.ndarray:
        """(M, R, N) IR data: measurements x receivers x samples."""
        return self.get_variable("Data.IR")

    def read_ir_rows(self, rows) -> np.ndarray:
        """(len(rows), R, N) IRs of the measurements `rows`: a contiguous
        Data.IR reads only those rows from the file, a chunked one whole."""
        return np.asarray(self._f["Data.IR"][np.asarray(rows, dtype=np.int64)])

    @property
    def ir_layout(self) -> str:
        """Data.IR's storage: "contiguous", "chunked" or "compact"."""
        return self._f["Data.IR"].layout

    @property
    def sampling_rate(self) -> float:
        sr = self.get_variable("Data.SamplingRate")
        return float(np.asarray(sr).reshape(-1)[0])

    @property
    def source_positions(self) -> np.ndarray:
        """(M, 3) source positions."""
        return self.get_variable("SourcePosition")[:, :3]

    @property
    def listener_positions(self) -> np.ndarray:
        """(M, 3) listener positions, a single row broadcast to M measurements."""
        lp = self.get_variable("ListenerPosition")
        if lp.ndim == 1:
            lp = lp[None, :]
        m = self.data_shape[0]
        if lp.shape[0] == 1 and m > 1:
            lp = np.repeat(lp, m, axis=0)
        return lp[:, :3]

    @property
    def receiver_positions(self) -> np.ndarray:
        """(R, 3) receiver (capsule) positions relative to the listener."""
        rp = self.get_variable("ReceiverPosition")
        if rp.ndim == 3:  # SOFA stores (R, C, I) or (R, C)
            rp = rp[:, :, 0]
        return rp[:, :3]

    @property
    def data_shape(self) -> tuple:
        return tuple(self._f["Data.IR"].shape)


def write_sofa(
    path: Union[str, Path],
    irs: np.ndarray,
    source_positions: np.ndarray,
    listener_position: np.ndarray,
    receiver_positions: np.ndarray,
    sample_rate: float,
    listener_short_name: str = "mic",
    conventions: str = "SingleRoomSRIR",
    extra_attrs: Optional[dict] = None,
) -> Path:
    """Write a minimal SingleRoomSRIR-style SOFA file.

    Arguments:
        irs: (M, R, N) array of IRs (measurements x receivers x samples).
        source_positions: (M, 3) cartesian source positions.
        listener_position: (3,) or (M, 3) listener position(s).
        receiver_positions: (R, 3) capsule offsets relative to the listener.
        extra_attrs: further global attributes, each a str.
    """
    irs = np.asarray(irs, dtype=np.float64)
    m, r, n = irs.shape
    listener_position = np.atleast_2d(np.asarray(listener_position, dtype=np.float64))
    attrs = {
        "Conventions": "SOFA",
        "SOFAConventions": conventions,
        "SOFAConventionsVersion": "1.0",
        "DataType": "FIR",
        "ListenerShortName": listener_short_name,
        "Title": f"audiblelight_tpu {conventions}",
        **(extra_attrs or {}),
    }
    datasets = {
        "Data.IR": irs,
        "Data.SamplingRate": np.array([float(sample_rate)]),
        "Data.Delay": np.zeros((1, r)),
        "SourcePosition": np.asarray(source_positions, dtype=np.float64),
        "ListenerPosition": np.broadcast_to(listener_position, (m, 3)),
        "ReceiverPosition": np.asarray(receiver_positions, dtype=np.float64)[:, :, None],
        "ListenerUp": np.tile([[0.0, 0.0, 1.0]], (m, 1)),
        "ListenerView": np.tile([[1.0, 0.0, 0.0]], (m, 1)),
    }
    return hdf5.write_file(path, datasets, attrs)


__all__ = ["SOFAFile", "write_sofa"]
