"""The subset of HDF5 that SOFA files use, read and written with numpy only.

SOFA files are netCDF-4 containers, which are HDF5 files. This module reads
what the SOFA files users meet contain, without h5py: files from the
package's own writers (`io.sofa.write_sofa`, `rir.hrtf.write_hrtf_sofa`),
files h5py writes at its default and at ``libver="latest"``, and netCDF-4
files from the SOFA toolboxes. Arrays come back bit-equal to what h5py
returns, in the stored dtype; attributes come back as h5py gives them
(``str`` for a variable-length string, ``numpy.bytes_`` for a fixed-length
one, a numpy scalar or array otherwise).

What it reads:

- superblocks v0-v3; object headers v1 and v2 (``OHDR``/``OCHK``, checksums
  verified), continuation messages included;
- groups as symbol tables (v1 B-tree of type 0, local heap, ``SNOD`` nodes),
  compact link messages, and dense links (a fractal heap and a v2 B-tree
  name index); attributes in the header or in dense storage;
- IEEE float (2, 4 and 8 bytes) and fixed-point integers in either byte
  order, fixed-length strings and variable-length strings (global heap);
- scalar and simple dataspaces; compact, contiguous (read by rows where the
  caller indexes the first axis) and chunked layouts of layout messages v3
  and v4 (HDF5 1.8 on): a v1 B-tree (v3), and the single-chunk, implicit
  and fixed-array indexes of v4; an unallocated dataset reads as its fill
  value;
- the deflate, shuffle and fletcher32 filters (the checksum is verified).

Anything else raises ``NotImplementedError("HDF5 <feature> is not supported
by the port's SOFA reader")`` when the object that needs it is read, never
before: a netCDF-4 file's ``DIMENSION_LIST`` and ``REFERENCE_LIST``
attributes (variable-length references, compounds) raise only when asked
for, so the rest of the file reads.

The writer (`write_file`) covers what the package's SOFA writers need:
superblock v0, v1 object headers, one root symbol table (the group leaf K
is raised to hold every entry in one node), contiguous little-endian float64
(or float32) datasets, variable-length UTF-8 string attributes in a global
heap, as h5py stores a Python ``str``, and scalar int64 attributes, as h5py
stores a Python ``int`` (the acoustic-image file of `Scene.generate_acoustic_image`).
"""

from __future__ import annotations

import os
import struct
import zlib
from pathlib import Path
from typing import Any, Iterator, Optional, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"


def _unsupported(feature: str) -> NotImplementedError:
    return NotImplementedError(f"HDF5 {feature} is not supported by the port's SOFA reader")


# ---------------------------------------------------------------------------
# Checksums
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, HDF5's metadata checksum."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    if n == 0:
        return c
    tail = n - ((n - 1) // 12) * 12
    words = struct.unpack(f"<{(n - tail) // 4}I", data[: n - tail])
    for i in range(0, len(words), 3):
        a = (a + words[i]) & _M32
        b = (b + words[i + 1]) & _M32
        c = (c + words[i + 2]) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 4); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 6); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 8); b = (b + a) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 4); b = (b + a) & _M32
    ta, tb, tc = struct.unpack("<3I", data[n - tail:] + bytes(12 - tail))
    a, b, c = (a + ta) & _M32, (b + tb) & _M32, (c + tc) & _M32
    c ^= b; c = (c - _rot(b, 14)) & _M32
    a ^= c; a = (a - _rot(c, 11)) & _M32
    b ^= a; b = (b - _rot(a, 25)) & _M32
    c ^= b; c = (c - _rot(b, 16)) & _M32
    a ^= c; a = (a - _rot(c, 4)) & _M32
    b ^= a; b = (b - _rot(a, 14)) & _M32
    c ^= b; c = (c - _rot(b, 24)) & _M32
    return c


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32): big-endian 16-bit words,
    sums folded to 16 bits after every 360 words, as the library folds them."""
    n = len(data)
    words = np.frombuffer(data[: n - n % 2], dtype=">u2").astype(np.int64)
    sum1 = sum2 = 0
    for i in range(0, len(words), 360):
        w = words[i:i + 360]
        sum2 += len(w) * sum1 + int(np.cumsum(w).sum())
        sum1 += int(w.sum())
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if n % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


def _verify(block: bytes, what: str) -> None:
    stored = struct.unpack("<I", block[-4:])[0]
    if lookup3(block[:-4]) != stored:
        raise ValueError(f"HDF5 {what} checksum mismatch")


# ---------------------------------------------------------------------------
# Low-level access
# ---------------------------------------------------------------------------


class _Source:
    """Positioned reads of one file, with the superblock's field sizes."""

    def __init__(self, path: Path):
        self.path = path
        self.fh = open(path, "rb")
        self.fd = self.fh.fileno()
        self.size_of_offsets = 8
        self.size_of_lengths = 8
        self.base = 0

    def read(self, offset: int, n: int) -> bytes:
        out = os.pread(self.fd, n, self.base + offset)
        if len(out) != n:
            raise ValueError(f"HDF5 file {self.path} ends before byte {self.base + offset + n}")
        return out

    def read_into(self, offset: int, out: np.ndarray) -> None:
        buf = memoryview(out).cast("B")
        got = 0
        while got < len(buf):
            k = os.preadv(self.fd, [buf[got:]], self.base + offset + got)
            if k <= 0:
                raise ValueError(f"HDF5 file {self.path} ends inside a dataset")
            got += k

    def close(self) -> None:
        self.fh.close()


class _Cursor:
    """Sequential little-endian decoding of a byte block."""

    def __init__(self, src: _Source, buf: bytes, pos: int = 0):
        self.src, self.buf, self.pos = src, buf, pos

    def take(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("HDF5 structure ends early")
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def u8(self) -> int:
        return self.uint(1)

    def u16(self) -> int:
        return self.uint(2)

    def u32(self) -> int:
        return self.uint(4)

    def u64(self) -> int:
        return self.uint(8)

    def addr(self) -> int:
        v = self.uint(self.src.size_of_offsets)
        return -1 if v == (1 << (8 * self.src.size_of_offsets)) - 1 else v

    def length(self) -> int:
        return self.uint(self.src.size_of_lengths)

    def skip(self, n: int) -> None:
        self.pos += n

    def align(self, k: int) -> None:
        self.pos = -(-self.pos // k) * k


def _bytes_for(n: int) -> int:
    """Bytes HDF5 uses to encode values up to n (H5VM_limit_enc_size)."""
    return (max(int(n), 1).bit_length() - 1) // 8 + 1


# ---------------------------------------------------------------------------
# Datatypes and dataspaces
# ---------------------------------------------------------------------------


class _Datatype:
    """A decoded datatype message: a numpy dtype, or a variable-length string."""

    def __init__(self, size: int, dtype: Optional[np.dtype], vlen_str: bool = False,
                 unsupported: Optional[str] = None):
        self.size, self.dtype = size, dtype
        self.vlen_str, self.unsupported = vlen_str, unsupported


_CLASS_NAMES = {2: "time datatype", 4: "bitfield datatype", 5: "opaque datatype",
                6: "compound datatype", 7: "reference datatype", 8: "enumerated datatype",
                10: "array datatype"}


def _parse_datatype(c: _Cursor) -> _Datatype:
    cls = c.u8() & 0x0F
    bits = c.uint(3)
    size = c.u32()
    order = ">" if bits & 1 else "<"
    if cls == 0:  # fixed-point
        c.skip(4)
        if size not in (1, 2, 4, 8):
            return _Datatype(size, None, unsupported=f"{8 * size}-bit integer datatype")
        kind = "i" if bits & 0x08 else "u"
        return _Datatype(size, np.dtype(f"{order}{kind}{size}"))
    if cls == 1:  # floating point
        c.skip(4)
        exp_loc, exp_size, man_loc, man_size = c.u8(), c.u8(), c.u8(), c.u8()
        c.skip(4)
        ieee = {2: (10, 5, 0, 10), 4: (23, 8, 0, 23), 8: (52, 11, 0, 52)}
        if bits & 0x40 or ieee.get(size) != (exp_loc, exp_size, man_loc, man_size):
            return _Datatype(size, None, unsupported="non-IEEE floating-point datatype")
        return _Datatype(size, np.dtype(f"{order}f{size}"))
    if cls == 3:  # fixed-length string
        return _Datatype(size, np.dtype(f"S{size}"))
    if cls == 9 and bits & 0x0F == 1:  # variable-length string
        return _Datatype(size, np.dtype(object), vlen_str=True)
    # A class the reader does not decode: its properties are never needed,
    # since every caller knows where the message that holds it ends.
    name = "variable-length sequence datatype" if cls == 9 else _CLASS_NAMES.get(cls, f"datatype class {cls}")
    return _Datatype(size, None, unsupported=name)


def _parse_dataspace(c: _Cursor) -> Optional[tuple]:
    """(shape, maxshape); shape None for a null dataspace."""
    version, rank, flags = c.u8(), c.u8(), c.u8()
    if version == 1:
        c.skip(5)
        kind = 1 if rank else 0
    elif version == 2:
        kind = c.u8()
    else:
        raise _unsupported(f"dataspace message version {version}")
    if kind == 2:
        return None, None
    dims = tuple(c.length() for _ in range(rank))
    maxdims = tuple(c.length() for _ in range(rank)) if flags & 1 else dims
    maxdims = tuple(None if m == (1 << (8 * c.src.size_of_lengths)) - 1 else m for m in maxdims)
    return dims, maxdims


def _fill_from(msgs: list) -> Optional[bytes]:
    """The defined fill value's bytes from a fill-value message (0x0005), else None."""
    for mtype, _, data in msgs:
        if mtype != 0x0005:
            continue
        version = data[0]
        if version in (1, 2):
            defined = data[3]
            if version == 1 or defined:
                size = struct.unpack_from("<I", data, 4)[0] if len(data) >= 8 else 0
                return bytes(data[8:8 + size]) if size else None
            return None
        flags = data[1]
        if flags & 0x20:
            size = struct.unpack_from("<I", data, 2)[0]
            return bytes(data[6:6 + size]) if size else None
        return None
    for mtype, _, data in msgs:
        if mtype == 0x0004:
            size = struct.unpack_from("<I", data, 0)[0]
            return bytes(data[4:4 + size]) if size else None
    return None


# ---------------------------------------------------------------------------
# Object headers
# ---------------------------------------------------------------------------


def _read_object_header(src: _Source, addr: int) -> list:
    """[(type, flags, data bytes)] of the object header at `addr`, continuations followed."""
    first = src.read(addr, 16)
    msgs: list = []
    if first[:4] == b"OHDR":
        _read_v2_header(src, addr, msgs)
        return msgs
    if first[0] != 1:
        raise _unsupported(f"object header version {first[0]}")
    n_msgs, _, size = struct.unpack_from("<HII", first, 2)
    blocks = [(addr + 16, size)]
    while blocks:
        off, length = blocks.pop(0)
        c = _Cursor(src, src.read(off, length))
        while c.pos + 8 <= length:
            mtype, msize, mflags = struct.unpack_from("<HHB", c.buf, c.pos)
            c.skip(8)
            data = c.take(msize)
            if mtype == 0x0010:
                cc = _Cursor(src, data)
                blocks.append((cc.addr(), cc.length()))
            elif mtype != 0:
                msgs.append((mtype, mflags, data))
    return msgs


def _read_v2_header(src: _Source, addr: int, msgs: list) -> None:
    head = src.read(addr, 32)
    flags = head[5]
    pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
    size_len = 1 << (flags & 3)
    chunk_size = int.from_bytes(head[pos:pos + size_len], "little")
    pos += size_len
    block = src.read(addr, pos + chunk_size + 4)
    _verify(block, "object header")
    blocks = [(block, pos, pos + chunk_size)]
    while blocks:
        buf, start, end = blocks.pop(0)
        c = _Cursor(src, buf, start)
        hdr = 4 + (2 if flags & 0x04 else 0)
        while c.pos + hdr <= end:
            mtype, msize, mflags = buf[c.pos], struct.unpack_from("<H", buf, c.pos + 1)[0], buf[c.pos + 3]
            c.skip(hdr)
            data = c.take(msize)
            if mtype == 0x0010:
                cc = _Cursor(src, data)
                caddr, clen = cc.addr(), cc.length()
                cblock = src.read(caddr, clen)
                if cblock[:4] != b"OCHK":
                    raise ValueError("HDF5 continuation block without its OCHK signature")
                _verify(cblock, "object header continuation")
                blocks.append((cblock, 4, clen - 4))
            elif mtype != 0:
                msgs.append((mtype, mflags, data))


# ---------------------------------------------------------------------------
# Heaps and B-trees
# ---------------------------------------------------------------------------


class _LocalHeap:
    def __init__(self, src: _Source, addr: int):
        c = _Cursor(src, src.read(addr, 8 + 2 * src.size_of_lengths + src.size_of_offsets))
        if c.take(4) != b"HEAP":
            raise ValueError("HDF5 local heap without its signature")
        c.skip(4)
        size = c.length()
        c.length()
        self.data = src.read(c.addr(), size)

    def string(self, offset: int) -> str:
        end = self.data.index(b"\0", offset)
        return self.data[offset:end].decode("utf-8")


def _global_heap_object(src: _Source, addr: int, index: int, cache: dict) -> bytes:
    if addr not in cache:
        head = src.read(addr, 8 + src.size_of_lengths)
        if head[:4] != b"GCOL":
            raise ValueError("HDF5 global heap collection without its signature")
        size = int.from_bytes(head[8:8 + src.size_of_lengths], "little")
        buf = src.read(addr, size)
        objs = {}
        c = _Cursor(src, buf, 8 + src.size_of_lengths)
        while c.pos + 8 + src.size_of_lengths <= size:
            idx = c.u16()
            c.skip(6)
            n = c.length()
            if idx == 0:
                break
            objs[idx] = c.take(n)
            c.align(8)
        cache[addr] = objs
    try:
        return cache[addr][index]
    except KeyError:
        raise ValueError(f"HDF5 global heap object {index} missing at {addr}") from None


def _v1_btree_children(src: _Source, addr: int, key_size: int) -> Iterator[tuple]:
    """Yield (key bytes, child address) of every leaf entry of a v1 B-tree."""
    o = src.size_of_offsets
    head = src.read(addr, 8 + 2 * o)
    if head[:4] != b"TREE":
        raise ValueError("HDF5 v1 B-tree node without its signature")
    level, used = head[5], struct.unpack_from("<H", head, 6)[0]
    body = src.read(addr + 8 + 2 * o, used * (key_size + o) + key_size)
    c = _Cursor(src, body)
    for _ in range(used):
        key = c.take(key_size)
        child = c.addr()
        if level == 0:
            yield key, child
        else:
            yield from _v1_btree_children(src, child, key_size)


class _FractalHeap:
    """A fractal heap's managed and tiny objects, located from their heap IDs."""

    def __init__(self, src: _Source, addr: int):
        o, L = src.size_of_offsets, src.size_of_lengths
        c = _Cursor(src, src.read(addr, 4 + 1 + 2 + 2 + 1 + 4 + L + o + L + o + 8 * L + 2 + L + L + 2 + 2 + o + 2))
        if c.take(4) != b"FRHP":
            raise ValueError("HDF5 fractal heap without its signature")
        self.src = src
        c.skip(1)
        self.id_len, filter_len, self.flags = c.u16(), c.u16(), c.u8()
        self.max_managed = c.u32()
        c.length(); c.addr(); c.length(); c.addr()
        c.length(); c.length(); c.length(); c.length(); c.length(); c.length(); c.length(); c.length()
        self.width = c.u16()
        self.start_block = c.length()
        self.max_direct = c.length()
        self.max_heap_bits = c.u16()
        c.u16()
        self.root = c.addr()
        self.root_rows = c.u16()
        self.unsupported = "filtered fractal heap" if filter_len else None
        # Heap ID fields (H5HF__hdr_finish_init_phase1)
        self.off_bytes = (self.max_heap_bits + 7) // 8
        self.len_bytes = min((self.max_direct.bit_length() - 1 + 7) // 8, _bytes_for(self.max_managed))
        # Rows whose blocks are direct: sizes start, start, 2 start, 4 start, ... up to max_direct
        self.max_direct_rows = (self.max_direct // self.start_block).bit_length() + 1

    def _row_size(self, row: int) -> int:
        return self.start_block * (1 << max(row - 1, 0))

    def get(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 3
        if kind == 2:
            if self.id_len > 18:
                n = ((heap_id[0] & 0x0F) << 8 | heap_id[1]) + 1
                return bytes(heap_id[2:2 + n])
            n = (heap_id[0] & 0x0F) + 1
            return bytes(heap_id[1:1 + n])
        if kind == 1:
            raise _unsupported("fractal heap huge object")
        if self.unsupported:
            raise _unsupported(self.unsupported)
        off = int.from_bytes(heap_id[1:1 + self.off_bytes], "little")
        n = int.from_bytes(heap_id[1 + self.off_bytes:1 + self.off_bytes + self.len_bytes], "little")
        if self.root_rows == 0:
            block_addr, block_off = self.root, 0
        else:
            block_addr, block_off = self._locate(self.root, self.root_rows, 0, off)
        return self.src.read(block_addr + (off - block_off), n)

    def _locate(self, iblock: int, n_rows: int, iblock_off: int, off: int) -> tuple:
        """(direct block address, its heap offset) of the direct block holding `off`."""
        o = self.src.size_of_offsets
        prefix = 4 + 1 + o + self.off_bytes
        n_direct_rows = min(n_rows, self.max_direct_rows)
        entries = self.src.read(iblock + prefix, n_rows * self.width * o)
        pos, block_off = 0, iblock_off
        for row in range(n_rows):
            size = self._row_size(row)
            for _ in range(self.width):
                child = int.from_bytes(entries[pos:pos + o], "little")
                pos += o
                if block_off <= off < block_off + size:
                    if row < n_direct_rows:
                        return child, block_off
                    return self._locate(child, self._rows_for(size), block_off, off)
                block_off += size
        raise ValueError(f"HDF5 fractal heap offset {off} outside the heap")

    def _rows_for(self, size: int) -> int:
        """Rows of an indirect block that spans `size` bytes of heap space."""
        total, rows = 0, 0
        while total < size:
            total += self._row_size(rows) * self.width
            rows += 1
        return rows


def _v2_btree_records(src: _Source, addr: int) -> list:
    """Every record (raw bytes) of a v2 B-tree, in key order."""
    o = src.size_of_offsets
    head = src.read(addr, 16 + o + 2 + src.size_of_lengths + 4)
    if head[:4] != b"BTHD":
        raise ValueError("HDF5 v2 B-tree header without its signature")
    c = _Cursor(src, head, 5)
    c.u8()
    node_size, rec_size, depth = c.u32(), c.u16(), c.u16()
    c.skip(2)
    root, root_nrec = c.addr(), c.u16()
    _verify(head[:c.pos + src.size_of_lengths + 4], "v2 B-tree header")
    if root < 0:
        return []
    # Field sizes of the child pointers, level by level (H5B2__hdr_init)
    max_nrec = [(node_size - 10) // rec_size]
    cum_max = [max_nrec[0]]
    cum_size = [0]
    nrec_size = _bytes_for(max_nrec[0])
    for u in range(1, depth + 1):
        ptr = o + nrec_size + (cum_size[u - 1] if u > 1 else 0)
        max_nrec.append((node_size - (10 + ptr)) // (rec_size + ptr))
        cum_max.append((max_nrec[u] + 1) * cum_max[u - 1] + max_nrec[u])
        cum_size.append(_bytes_for(cum_max[u]))
    out: list = []

    def walk(node: int, nrec: int, level: int) -> None:
        buf = src.read(node, node_size)
        sig = b"BTLF" if level == 0 else b"BTIN"
        if buf[:4] != sig:
            raise ValueError(f"HDF5 v2 B-tree node without its {sig.decode()} signature")
        recs = [buf[6 + i * rec_size:6 + (i + 1) * rec_size] for i in range(nrec)]
        if level == 0:
            out.extend(recs)
            return
        c = _Cursor(src, buf, 6 + nrec * rec_size)
        kids = []
        for _ in range(nrec + 1):
            child = c.addr()
            n = c.uint(nrec_size)
            if level > 1:
                c.uint(cum_size[level - 1])
            kids.append((child, n))
        for i, (child, n) in enumerate(kids):
            walk(child, n, level - 1)
            if i < nrec:
                out.append(recs[i])

    walk(root, root_nrec, depth)
    return out


# ---------------------------------------------------------------------------
# Attributes
# ---------------------------------------------------------------------------


class _RawAttribute:
    """An attribute message, decoded only when its value is asked for."""

    def __init__(self, src: _Source, data: bytes, gcache: dict):
        self.src, self.data, self.gcache = src, data, gcache
        version = data[0]
        if version == 1:
            name_len, self._dt_len, self._ds_len = struct.unpack_from("<HHH", data, 2)
            self.name = bytes(data[8:8 + name_len]).rstrip(b"\0").decode("utf-8")
            self._dt_at = 8 + ((name_len + 7) // 8) * 8
            self._ds_at = self._dt_at + ((self._dt_len + 7) // 8) * 8
            self._data_at = self._ds_at + ((self._ds_len + 7) // 8) * 8
            self._flags = 0
        elif version in (2, 3):
            self._flags = data[1]
            name_len, self._dt_len, self._ds_len = struct.unpack_from("<HHH", data, 2)
            at = 8 + (1 if version == 3 else 0)
            self.name = bytes(data[at:at + name_len]).rstrip(b"\0").decode("utf-8")
            self._dt_at = at + name_len
            self._ds_at = self._dt_at + self._dt_len
            self._data_at = self._ds_at + self._ds_len
        else:
            raise _unsupported(f"attribute message version {version}")

    def value(self) -> Any:
        if self._flags & 3:
            raise _unsupported("shared attribute datatype or dataspace")
        dt = _parse_datatype(_Cursor(self.src, self.data, self._dt_at))
        if dt.unsupported:
            raise _unsupported(dt.unsupported)
        shape, _ = _parse_dataspace(_Cursor(self.src, self.data, self._ds_at))
        if shape is None:
            return None
        count = int(np.prod(shape, dtype=np.int64))
        raw = self.data[self._data_at:self._data_at + count * dt.size]
        if dt.vlen_str:
            arr = np.empty(count, dtype=object)
            for i in range(count):
                arr[i] = _vlen_string(self.src, raw[i * dt.size:(i + 1) * dt.size], self.gcache)
            arr = arr.reshape(shape)
            return arr[()] if shape == () else arr
        arr = np.frombuffer(raw, dtype=dt.dtype, count=count).reshape(shape).copy()
        return arr[()] if shape == () else arr


def _vlen_string(src: _Source, ref: bytes, gcache: dict, as_str: bool = True):
    c = _Cursor(src, ref)
    n, coll, idx = c.u32(), c.addr(), c.u32()
    raw = b"" if n == 0 or coll < 0 else _global_heap_object(src, coll, idx, gcache)[:n]
    return raw.decode("utf-8", "surrogateescape") if as_str else raw


class AttributeManager:
    """h5py-like read-only mapping of an object's attributes."""

    def __init__(self, raw: dict):
        self._raw = raw

    def __getitem__(self, name: str) -> Any:
        return self._raw[name].value()

    def __contains__(self, name: str) -> bool:
        return name in self._raw

    def __iter__(self) -> Iterator[str]:
        return iter(self._raw)

    def __len__(self) -> int:
        return len(self._raw)

    def keys(self) -> list:
        return list(self._raw)

    def get(self, name: str, default: Any = None) -> Any:
        return self[name] if name in self._raw else default

    def items(self) -> Iterator[tuple]:
        for k in self._raw:
            yield k, self[k]


def _attributes(src: _Source, msgs: list, gcache: dict) -> AttributeManager:
    raw: dict = {}
    for mtype, mflags, data in msgs:
        if mtype == 0x000C:
            if mflags & 2:
                raise _unsupported("shared attribute message")
            a = _RawAttribute(src, data, gcache)
            raw[a.name] = a
        elif mtype == 0x0015:
            c = _Cursor(src, data)
            c.u8()
            flags = c.u8()
            if flags & 1:
                c.u16()
            heap_addr, name_index = c.addr(), c.addr()
            if heap_addr < 0:
                continue
            heap = _FractalHeap(src, heap_addr)
            for rec in _v2_btree_records(src, name_index):
                a = _RawAttribute(src, heap.get(rec[:heap.id_len]), gcache)
                raw[a.name] = a
    return AttributeManager(raw)


# ---------------------------------------------------------------------------
# Objects
# ---------------------------------------------------------------------------


class _Object:
    def __init__(self, file: "File", addr: int, name: str):
        self.file, self.addr, self.name = file, addr, name
        self._msgs = _read_object_header(file._src, addr)
        self.attrs = _attributes(file._src, self._msgs, file._gcache)


class Group(_Object):
    """An HDF5 group: a read-only mapping of names to datasets and groups."""

    def __init__(self, file: "File", addr: int, name: str):
        super().__init__(file, addr, name)
        self._links: Optional[dict] = None

    @property
    def links(self) -> dict:
        """{name: object header address}; a soft or external link maps to its kind."""
        if self._links is None:
            self._links = self._read_links()
        return self._links

    def _read_links(self) -> dict:
        src = self.file._src
        links: dict = {}
        for mtype, _, data in self._msgs:
            if mtype == 0x0011:  # symbol table
                c = _Cursor(src, data)
                btree, heap_addr = c.addr(), c.addr()
                heap = _LocalHeap(src, heap_addr)
                for _, snod in _v1_btree_children(src, btree, src.size_of_lengths):
                    links.update(self._snod_entries(snod, heap))
            elif mtype == 0x0006:
                name, target = _parse_link(src, data)
                links[name] = target
            elif mtype == 0x0002:
                c = _Cursor(src, data)
                c.u8()
                flags = c.u8()
                if flags & 1:
                    c.u64()
                heap_addr, name_index = c.addr(), c.addr()
                if heap_addr < 0:
                    continue
                heap = _FractalHeap(src, heap_addr)
                for rec in _v2_btree_records(src, name_index):
                    name, target = _parse_link(src, heap.get(rec[4:4 + heap.id_len]))
                    links[name] = target
        return links

    def _snod_entries(self, addr: int, heap: _LocalHeap) -> dict:
        src = self.file._src
        o = src.size_of_offsets
        head = src.read(addr, 8)
        if head[:4] != b"SNOD":
            raise ValueError("HDF5 symbol table node without its signature")
        n = struct.unpack_from("<H", head, 6)[0]
        entry = 2 * o + 24
        c = _Cursor(src, src.read(addr + 8, n * entry))
        out = {}
        for _ in range(n):
            name_off, header = c.uint(o), c.addr()
            c.skip(24)
            out[heap.string(name_off)] = header
        return out

    def _resolve(self, name: str) -> int:
        target = self.links[name]
        if isinstance(target, str):
            raise _unsupported(target)
        return target

    def __getitem__(self, path: str) -> Union["Group", "Dataset"]:
        parts = [p for p in str(path).split("/") if p]
        obj: Union[Group, Dataset] = self
        for part in parts:
            if not isinstance(obj, Group):
                raise KeyError(path)
            if part not in obj.links:
                raise KeyError(f"Unable to open object '{path}' (object not found)")
            obj = self.file._open(obj._resolve(part), part)
        return obj

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self.links))

    def __len__(self) -> int:
        return len(self.links)

    def keys(self) -> list:
        return sorted(self.links)


def _parse_link(src: _Source, data: bytes) -> tuple:
    c = _Cursor(src, data)
    c.u8()
    flags = c.u8()
    kind = c.u8() if flags & 0x08 else 0
    if flags & 0x04:
        c.u64()
    if flags & 0x10:
        c.u8()
    name = c.take(c.uint(1 << (flags & 3))).decode("utf-8")
    if kind == 0:
        return name, c.addr()
    return name, "soft link" if kind == 1 else "external link" if kind == 64 else f"link type {kind}"


class Dataset(_Object):
    """An HDF5 dataset, read on demand: ``ds[()]``, ``ds[rows]`` or ``np.asarray(ds)``."""

    def __init__(self, file: "File", addr: int, name: str):
        super().__init__(file, addr, name)
        src = file._src
        by_type = {}
        for mtype, mflags, data in self._msgs:
            if mflags & 2 and mtype in (0x0001, 0x0003, 0x0008, 0x000B):
                raise _unsupported("shared object header message")
            by_type.setdefault(mtype, data)
        self._dt = _parse_datatype(_Cursor(src, by_type[0x0003]))
        self.shape, self.maxshape = _parse_dataspace(_Cursor(src, by_type[0x0001]))
        self.dtype = self._dt.dtype
        self._layout = by_type.get(0x0008)
        self._filters = _parse_filters(by_type[0x000B]) if 0x000B in by_type else []
        self._fill = _fill_from(self._msgs)

    @property
    def layout(self) -> str:
        """"compact", "contiguous" or "chunked"."""
        kind = self._parse_layout()[0]
        return kind if kind in ("compact", "contiguous") else "chunked"

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __array__(self, dtype=None, copy=None):
        arr = self[()]
        return arr if dtype is None else arr.astype(dtype)

    def _check_type(self) -> None:
        if self._dt.unsupported:
            raise _unsupported(self._dt.unsupported)
        if self.shape is None:
            raise _unsupported("null dataspace")

    def __getitem__(self, key) -> Any:
        self._check_type()
        layout = self._parse_layout()
        whole = isinstance(key, tuple) and len(key) == 0
        if (not whole and layout[0] == "contiguous" and layout[1] >= 0 and self.ndim >= 1
                and not self._dt.vlen_str):
            key = key if isinstance(key, tuple) else (key,)
            if key[0] is not Ellipsis:
                return self._rows(layout[1], key)
        arr = self._read_all(layout)
        if whole:
            return arr[()] if self.shape == () else arr
        return arr[key]

    def _rows(self, addr: int, key: tuple) -> np.ndarray:
        """Read only the rows the first index selects (contiguous layout)."""
        rows = np.arange(self.shape[0])[key[0]]
        row_shape = self.shape[1:]
        row_bytes = int(np.prod(row_shape, dtype=np.int64)) * self._dt.size
        flat = np.atleast_1d(rows)
        out = np.empty((len(flat),) + row_shape, dtype=self.dtype)
        i = 0
        while i < len(flat):  # coalesce runs of consecutive rows into one read
            j = i + 1
            while j < len(flat) and flat[j] == flat[j - 1] + 1:
                j += 1
            self.file._src.read_into(addr + int(flat[i]) * row_bytes, out[i:j])
            i = j
        out = out[0] if np.ndim(rows) == 0 else out
        return out[(slice(None),) * (np.ndim(rows)) + key[1:]] if len(key) > 1 else out

    def _parse_layout(self) -> tuple:
        if self._layout is None:
            raise ValueError(f"HDF5 dataset {self.name} has no layout message")
        src = self.file._src
        c = _Cursor(src, self._layout)
        version = c.u8()
        if version not in (3, 4):
            raise _unsupported(f"data layout message version {version}")
        cls = c.u8()
        if cls == 0:
            return ("compact", bytes(c.take(c.u16())))
        if cls == 1:
            return ("contiguous", c.addr())
        if cls != 2:
            raise _unsupported("virtual dataset layout")
        if version == 3:
            rank = c.u8()
            addr = c.addr()
            dims = [c.u32() for _ in range(rank)]
            return ("btree1", addr, tuple(dims[:-1]))
        flags, rank, dim_bytes = c.u8(), c.u8(), c.u8()
        dims = [c.uint(dim_bytes) for _ in range(rank)]
        index = c.u8()
        chunk = tuple(dims[:-1])
        if index == 1:
            filtered = None
            if flags & 2:
                size, mask = c.length(), c.u32()
                filtered = (size, mask)
            return ("single", c.addr(), chunk, filtered)
        if index == 2:
            return ("implicit", c.addr(), chunk)
        if index == 3:
            c.u8()
            return ("farray", c.addr(), chunk)
        if index == 4:
            return ("unsupported", "extensible-array chunk index")
        if index == 5:
            return ("unsupported", "v2-B-tree chunk index")
        return ("unsupported", f"chunk index type {index}")

    def _read_all(self, layout: tuple) -> np.ndarray:
        src, dt, shape = self.file._src, self._dt, self.shape
        count = int(np.prod(shape, dtype=np.int64))
        kind = layout[0]
        if kind == "unsupported":
            raise _unsupported(layout[1])
        if kind == "compact":
            flat = self._decode(layout[1][:count * dt.size], count)
        elif kind == "contiguous":
            if layout[1] < 0:
                flat = self._filled(count)
            elif dt.vlen_str:
                flat = self._decode(src.read(layout[1], count * dt.size), count)
            else:
                flat = np.empty(count, dtype=dt.dtype)
                src.read_into(layout[1], flat)
        else:
            return self._read_chunked(layout).reshape(shape)
        return flat.reshape(shape)

    def _decode(self, raw: bytes, count: int) -> np.ndarray:
        if self._dt.vlen_str:  # h5py reads a dataset's variable-length strings as bytes
            size, out = self._dt.size, np.empty(count, dtype=object)
            for i in range(count):
                out[i] = _vlen_string(self.file._src, raw[i * size:(i + 1) * size], self.file._gcache, False)
            return out
        return np.frombuffer(raw, dtype=self._dt.dtype, count=count).copy()

    def _filled(self, count: int) -> np.ndarray:
        if self._fill is not None and not self._dt.vlen_str:
            return np.repeat(np.frombuffer(self._fill, dtype=self._dt.dtype, count=1), count)
        return np.zeros(count, dtype=self._dt.dtype)

    def _chunk_list(self, layout: tuple) -> list:
        """[(chunk offsets in elements, address, stored size, filter mask)]."""
        src = self.file._src
        kind, addr, chunk = layout[0], layout[1], layout[2]
        shape = self.shape
        chunk_bytes = int(np.prod(chunk, dtype=np.int64)) * self._dt.size
        if addr < 0:
            return []
        if kind == "btree1":
            rank = len(chunk)
            out = []
            for key, child in _v1_btree_children(src, addr, 8 + 8 * (rank + 1)):
                size, mask = struct.unpack_from("<II", key, 0)
                offs = struct.unpack_from(f"<{rank}Q", key, 8)
                out.append((offs, child, size, mask))
            return out
        if kind == "single":
            size, mask = layout[3] if layout[3] else (chunk_bytes, 0)
            return [((0,) * len(shape), addr, size, mask)]
        grid = [-(-s // k) for s, k in zip(shape, chunk)]
        coords = list(np.ndindex(*grid))
        if kind == "implicit":
            return [(tuple(g * k for g, k in zip(cd, chunk)), addr + i * chunk_bytes, chunk_bytes, 0)
                    for i, cd in enumerate(coords)]
        entries = _fixed_array_entries(src, addr, len(coords), bool(self._filters))
        out = []
        for cd, (caddr, size, mask) in zip(coords, entries):
            if caddr >= 0:
                out.append((tuple(g * k for g, k in zip(cd, chunk)), caddr,
                            chunk_bytes if size is None else size, mask))
        return out

    def _read_chunked(self, layout: tuple) -> np.ndarray:
        if self._dt.vlen_str:
            raise _unsupported("chunked variable-length string dataset")
        src, chunk, shape = self.file._src, layout[2], self.shape
        out = np.empty(shape, dtype=self._dt.dtype)
        out[...] = self._filled(1)[0] if out.size else 0
        n_chunk = int(np.prod(chunk, dtype=np.int64))
        for offs, addr, size, mask in self._chunk_list(layout):
            raw = src.read(addr, size)
            for i in reversed(range(len(self._filters))):
                if not mask & (1 << i):
                    raw = _apply_filter(self._filters[i], raw, self._dt.size)
            block = np.frombuffer(raw, dtype=self._dt.dtype, count=n_chunk).reshape(chunk)
            sel = tuple(slice(o, min(o + k, s)) for o, k, s in zip(offs, chunk, shape))
            out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
        return out


def _fixed_array_entries(src: _Source, addr: int, n: int, filtered: bool) -> list:
    """[(chunk address, stored size or None, filter mask)] of a fixed-array chunk index."""
    o = src.size_of_offsets
    head = src.read(addr, 4 + 1 + 1 + 1 + 1 + src.size_of_lengths + o + 4)
    if head[:4] != b"FAHD":
        raise ValueError("HDF5 fixed array header without its signature")
    _verify(head, "fixed array header")
    c = _Cursor(src, head, 5)
    client, entry_size, page_bits = c.u8(), c.u8(), c.u8()
    n_entries = c.length()
    dblock = c.addr()
    page_n = 1 << page_bits
    prefix = 4 + 1 + 1 + o
    if n_entries > page_n:
        n_pages = -(-n_entries // page_n)
        bitmap_len = (n_pages + 7) // 8
        head2 = src.read(dblock, prefix + bitmap_len + 4)
        _verify(head2, "fixed array data block")
        bitmap = head2[prefix:prefix + bitmap_len]
        raw = bytearray()
        pos = dblock + prefix + bitmap_len + 4
        for p in range(n_pages):
            k = min(page_n, n_entries - p * page_n)
            page = src.read(pos, k * entry_size + 4)
            pos += k * entry_size + 4
            if bitmap[p // 8] & (0x80 >> (p % 8)):
                _verify(page, "fixed array page")
                raw += page[:-4]
            else:  # a page never written: every chunk unallocated
                raw += b"".join(b"\xff" * o + bytes(entry_size - o) for _ in range(k))
    else:
        block = src.read(dblock, prefix + n_entries * entry_size + 4)
        _verify(block, "fixed array data block")
        raw = block[prefix:prefix + n_entries * entry_size]
    out = []
    size_len = entry_size - o - 4
    for i in range(min(n, n_entries)):
        e = raw[i * entry_size:(i + 1) * entry_size]
        caddr = int.from_bytes(e[:o], "little")
        caddr = -1 if caddr == (1 << (8 * o)) - 1 else caddr
        if client == 1:
            size = int.from_bytes(e[o:o + size_len], "little")
            mask = int.from_bytes(e[o + size_len:o + size_len + 4], "little")
            out.append((caddr, size, mask))
        else:
            out.append((caddr, None, 0))
    return out


def _parse_filters(data: bytes) -> list:
    """[(filter id, client data)] of a filter pipeline message."""
    version, n = data[0], data[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = struct.unpack_from("<H", data, pos)[0]
        pos += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", data, pos)[0]
            pos += 2
        _, n_values = struct.unpack_from("<HH", data, pos)
        pos += 4
        pos += ((name_len + 7) // 8) * 8 if version == 1 else name_len
        values = struct.unpack_from(f"<{n_values}I", data, pos)
        pos += 4 * n_values
        if version == 1 and n_values % 2:
            pos += 4
        out.append((fid, values))
    return out


def _apply_filter(filt: tuple, raw: bytes, elem_size: int) -> bytes:
    fid, values = filt
    if fid == 1:
        return zlib.decompress(raw)
    if fid == 2:
        size = values[0] if values else elem_size
        n = len(raw) // size
        body = np.frombuffer(raw[:n * size], dtype=np.uint8).reshape(size, n).T.tobytes()
        return body + raw[n * size:]
    if fid == 3:
        data, stored = raw[:-4], struct.unpack("<I", raw[-4:])[0]
        sum_ = fletcher32(data)
        swapped = struct.unpack(">I", struct.pack("<I", sum_))[0]
        if stored not in (sum_, swapped):
            raise ValueError("HDF5 fletcher32 checksum mismatch in a chunk")
        return data
    names = {4: "SZIP filter", 5: "N-bit filter", 6: "scale-offset filter"}
    raise _unsupported(names.get(fid, f"filter {fid}"))


class File(Group):
    """An HDF5 file opened for reading (h5py-like: ``File(path)["Data.IR"][()]``)."""

    def __init__(self, path: Union[str, Path]):
        self.filename = str(path)
        self._src = _Source(Path(path))
        self._gcache: dict = {}
        self._objects: dict = {}
        try:
            root = self._superblock()
            super().__init__(self, root, "/")
        except BaseException:
            self._src.close()
            raise

    def _superblock(self) -> int:
        src = self._src
        at = 0
        while True:
            sig = src.read(at, 8)
            if sig == SIGNATURE:
                break
            at = 512 if at == 0 else at * 2
            if at > os.path.getsize(src.path):
                raise ValueError(f"{src.path} is not an HDF5 file")
        head = src.read(at, 24)
        version = head[8]
        if version in (0, 1):
            src.size_of_offsets, src.size_of_lengths = head[13], head[14]
            o = src.size_of_offsets
            pos = at + 24 + (4 if version == 1 else 0)
            c = _Cursor(src, src.read(pos, 4 * o + 2 * o + 8 + 16))
            base = c.addr()
            c.addr(); c.addr(); c.addr()
            c.addr()  # root entry's link name offset
            root = c.addr()
        elif version in (2, 3):
            src.size_of_offsets, src.size_of_lengths = head[9], head[10]
            o = src.size_of_offsets
            block = src.read(at, 12 + 4 * o + 4)
            _verify(block, "superblock")
            c = _Cursor(src, block, 12)
            base = c.addr()
            c.addr(); c.addr()
            root = c.addr()
        else:
            raise _unsupported(f"superblock version {version}")
        src.base = max(base, 0) if base >= 0 else at
        return root

    def _open(self, addr: int, name: str) -> Union[Group, Dataset]:
        if addr not in self._objects:
            msgs = _read_object_header(self._src, addr)
            types = {m[0] for m in msgs}
            if 0x0008 in types or 0x0003 in types and 0x0001 in types:
                self._objects[addr] = Dataset(self, addr, name)
            else:
                self._objects[addr] = Group(self, addr, name)
        return self._objects[addr]

    def close(self) -> None:
        self._src.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _pad8(b: bytes) -> bytes:
    return b + bytes(-len(b) % 8)


def _msg_v1(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _header_v1(messages: list) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


_VLEN_STR_TYPE = (struct.pack("<B3sI", 0x19, bytes([0x01, 0x01, 0x00]), 16)
                  + struct.pack("<B3sI", 0x10, bytes(3), 1) + struct.pack("<HH", 0, 8))
_F64_TYPE = struct.pack("<B3sI", 0x11, bytes([0x20, 0x3F, 0x00]), 8) + struct.pack(
    "<HHBBBBI", 0, 64, 52, 11, 0, 52, 1023)
_F32_TYPE = struct.pack("<B3sI", 0x11, bytes([0x20, 0x1F, 0x00]), 4) + struct.pack(
    "<HHBBBBI", 0, 32, 23, 8, 0, 23, 127)
_I64_TYPE = struct.pack("<B3sI", 0x10, bytes([0x08, 0x00, 0x00]), 8) + struct.pack("<HH", 0, 64)
_SCALAR_SPACE = struct.pack("<BBBB4x", 1, 0, 0, 0)


def _simple_space(shape: tuple) -> bytes:
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + b"".join(struct.pack("<Q", d) for d in shape)


def write_file(path: Union[str, Path], datasets: dict, attrs: Optional[dict] = None,
               dataset_attrs: Optional[dict] = None) -> Path:
    """Write an HDF5 file of float datasets and string or int64 attributes.

    Arguments:
        datasets: {name: array}; each is stored contiguous and little-endian,
            a float32 array as float32 and any other as float64.
        attrs: {name: str or np.int64} root attributes, a str as a
            variable-length UTF-8 string, an np.int64 as a scalar int64.
        dataset_attrs: {dataset name: {name: str or np.int64}} attributes of
            the datasets.

    The file is superblock v0 with v1 object headers and one root symbol
    table, as h5py writes at its default ``libver``; h5py reads it back to
    the same names, arrays and attributes (``str`` and ``np.int64``).
    """
    path = Path(path)
    attrs = dict(attrs or {})
    dataset_attrs = {k: dict(v) for k, v in (dataset_attrs or {}).items()}
    names = sorted(datasets, key=lambda s: s.encode("utf-8"))
    arrays = {k: np.array(datasets[k], dtype="<f4" if np.asarray(datasets[k]).dtype == np.float32 else "<f8",
                          order="C") for k in names}
    for k, v in list(attrs.items()) + [kv for d in dataset_attrs.values() for kv in d.items()]:
        if not isinstance(v, (str, np.int64)):
            raise TypeError(f"attribute {k!r}: the writer stores str values only, or np.int64 scalars, "
                            f"got {type(v).__name__}")

    leaf_k = max(4, -(-len(names) // 2))
    internal_k = 16
    o = 8
    sb_size = 56 + 40  # superblock v0 with its root symbol-table entry

    # Global heap: every string attribute's UTF-8 bytes
    strings = [v for v in list(attrs.values()) + [v for d in dataset_attrs.values() for v in d.values()]
               if isinstance(v, str)]
    heap_objs = []
    for i, s in enumerate(strings, start=1):
        raw = s.encode("utf-8")
        heap_objs.append(struct.pack("<HH4xQ", i, 1, len(raw)) + _pad8(raw))
    gcol_used = 16 + sum(len(h) for h in heap_objs)
    gcol_size = max(4096, gcol_used + 16)

    def attr_msg(name: str, value, index: Optional[int], gcol: int) -> bytes:
        """An int64 scalar (`index` None) or a global-heap string attribute."""
        nm = name.encode("utf-8") + b"\0"
        dtype = _I64_TYPE if index is None else _VLEN_STR_TYPE
        data = (struct.pack("<BBHHH", 1, 0, len(nm), len(dtype), len(_SCALAR_SPACE))
                + _pad8(nm) + _pad8(dtype) + _pad8(_SCALAR_SPACE))
        if index is None:
            data += struct.pack("<q", int(value))
        else:
            data += struct.pack("<IQI", len(value.encode("utf-8")), gcol, index)
        return _msg_v1(0x000C, data)

    # Layout: superblock | root header | B-tree | SNOD | local heap (+data) | GCOL | dataset headers | data
    counter = iter(range(1, len(strings) + 1))

    def heap_indices(values) -> list:
        return [next(counter) if isinstance(v, str) else None for v in values]

    root_attr_idx = heap_indices(attrs.values())
    ds_attr_idx = {k: heap_indices(dataset_attrs.get(k, {}).values()) for k in names}

    def root_header(btree: int, lheap: int, gcol: int) -> bytes:
        msgs = [_msg_v1(0x0011, struct.pack("<QQ", btree, lheap))]
        msgs += [attr_msg(n, v, i, gcol) for (n, v), i in zip(attrs.items(), root_attr_idx)]
        return _header_v1(msgs)

    root_len = len(root_header(0, 0, 0))
    btree_len = 8 + 2 * o + (2 * internal_k + 1) * 8 + 2 * internal_k * o
    snod_len = 8 + 2 * leaf_k * (2 * o + 24)
    heap_data = bytearray(8)  # offset 0: the empty name
    name_offsets = []
    for n in names:
        name_offsets.append(len(heap_data))
        heap_data += _pad8(n.encode("utf-8") + b"\0")
    free_off = len(heap_data)
    heap_data += struct.pack("<QQ", 1, 16)  # one free block: no next block (1), 16 bytes
    lheap_len = 32

    root_at = sb_size
    btree_at = root_at + root_len
    snod_at = btree_at + btree_len
    lheap_at = snod_at + snod_len
    lheap_data_at = lheap_at + lheap_len
    gcol_at = lheap_data_at + len(heap_data)

    def ds_header(k: str, data_at: int) -> bytes:
        arr = arrays[k]
        msgs = [
            _msg_v1(0x0001, _simple_space(arr.shape) if arr.ndim else _SCALAR_SPACE),
            _msg_v1(0x0003, _F32_TYPE if arr.dtype == np.float32 else _F64_TYPE, flags=1),
            _msg_v1(0x0005, struct.pack("<BBBB", 2, 2, 2, 1) + struct.pack("<I", 0)),
            _msg_v1(0x0008, struct.pack("<BBQQ", 3, 1, data_at if arr.nbytes else (1 << 64) - 1, arr.nbytes)),
        ]
        msgs += [attr_msg(n, v, i, gcol_at) for (n, v), i in zip(dataset_attrs.get(k, {}).items(), ds_attr_idx[k])]
        return _header_v1(msgs)

    pos = gcol_at + gcol_size
    hdr_at, hdrs = {}, {}
    for k in names:
        hdr_at[k] = pos
        pos += len(ds_header(k, 0))
    data_at = {}
    for k in names:
        data_at[k] = pos
        pos += arrays[k].nbytes
        hdrs[k] = ds_header(k, data_at[k])
    eof = pos

    sb = (SIGNATURE + struct.pack("<BBBBBBBB", 0, 0, 0, 0, 0, o, 8, 0)
          + struct.pack("<HHI", leaf_k, internal_k, 0)
          + struct.pack("<QQQQ", 0, (1 << 64) - 1, eof, (1 << 64) - 1)
          + struct.pack("<QQII", 0, root_at, 1, 0) + struct.pack("<QQ", btree_at, lheap_at))
    btree = (b"TREE" + struct.pack("<BBH", 0, 0, 1 if names else 0) + struct.pack("<qq", -1, -1))
    if names:
        btree += struct.pack("<QQQ", 0, snod_at, name_offsets[-1])
    btree += bytes(btree_len - len(btree))
    snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names))
    for k, off in zip(names, name_offsets):
        snod += struct.pack("<QQII16x", off, hdr_at[k], 0, 0)
    snod += bytes(snod_len - len(snod))
    lheap = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), free_off, lheap_data_at)
    gcol = b"GCOL" + struct.pack("<B3xQ", 1, gcol_size) + b"".join(heap_objs)
    free = gcol_size - len(gcol)
    gcol += struct.pack("<HH4xQ", 0, 0, free) + bytes(free - 16)

    with open(path, "wb") as f:
        f.write(sb)
        f.write(root_header(btree_at, lheap_at, gcol_at))
        f.write(btree)
        f.write(snod)
        f.write(lheap)
        f.write(heap_data)
        f.write(gcol)
        for k in names:
            f.write(hdrs[k])
        for k in names:
            f.write(arrays[k].tobytes())
    return path


__all__ = ["File", "Group", "Dataset", "AttributeManager", "write_file", "lookup3", "fletcher32"]
