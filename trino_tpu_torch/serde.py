"""Pages wire format: Batch <-> bytes for exchange and spill.

Reference: ``execution/buffer/PagesSerde.java:41,64`` (per-block encodings
+ optional LZ4 compression) and the wire magic ``0xfea4f001``
(``server/PagesResponseWriter.java:50``). Encodings per column:

  PLAIN    raw little-endian storage bytes (floats)
  VARINT   delta+zigzag varints (keys, timestamps — usually near-sorted)
  RLE      run-length (low-cardinality / constant columns)
  BOOL     1-bit bitpack

Validity masks bitpack to 1 bit/row; varchar ships dictionary + codes.
The whole payload is LZ-compressed (``tt_lz_*`` in ``csrc/columnar.cpp``,
or its Python transcription under ``native_decode=false``: the same
stream). Pages tagged zlib, which the reference writes when its native
library did not build, are read too.

A copy of ``trino_tpu/serde.py`` on the port's :class:`Batch`: the bytes
equal the reference's for the same batch. It serializes host tensors; a
CUDA batch comes to the host first (``Batch.compact``).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import Batch, Column, Dictionary, as_tensor
from trino_tpu_torch.native import (
    bitpack_decode,
    bitpack_encode,
    lz_compress,
    lz_decompress,
    rle_decode,
    rle_encode,
    varint_decode,
    varint_encode,
)

PAGES_MAGIC = 0xFEA4F001
# format version: bumped when the per-column layout changes (v2 added the
# wide-DECIMAL lane flag); readers reject other versions loudly instead of
# misparsing persisted part files
PAGES_VERSION = 3  # v3: typed dictionary values (ARRAY pools over the wire)
_CODEC_LZ = 0  # csrc/columnar.cpp tt_lz_*
_CODEC_ZLIB = 1

_ENC_PLAIN, _ENC_VARINT, _ENC_RLE, _ENC_BOOL = 0, 1, 2, 3


def _pack_bytes(b: bytes) -> bytes:
    return struct.pack("<q", len(b)) + b


# --- typed dictionary values (strings AND array pools) ----------------------
# ARRAY columns pool distinct array VALUES (python tuples of scalars/None)
# exactly like varchar pools strings; the wire must carry both
# (reference: ArrayBlock offsets+values — here pool + codes).


def _enc_value(v) -> bytes:
    if v is None:
        return b"\x00"
    if isinstance(v, bool):
        return b"\x01" + (b"\x01" if v else b"\x00")
    if isinstance(v, (int, np.integer)):
        return b"\x02" + struct.pack("<q", int(v))
    if isinstance(v, (float, np.floating)):
        return b"\x03" + struct.pack("<d", float(v))
    if isinstance(v, str):
        b = v.encode("utf-8", "surrogatepass")
        return b"\x04" + struct.pack("<i", len(b)) + b
    if isinstance(v, tuple):
        return b"\x05" + struct.pack("<i", len(v)) + b"".join(
            _enc_value(e) for e in v
        )
    raise ValueError(f"unsupported dictionary value type {type(v)!r}")


def _dec_value(buf: bytes, pos: int):
    tag = buf[pos]
    pos += 1
    if tag == 0:
        return None, pos
    if tag == 1:
        return buf[pos] == 1, pos + 1
    if tag == 2:
        return struct.unpack_from("<q", buf, pos)[0], pos + 8
    if tag == 3:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if tag == 4:
        (ln,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        return buf[pos : pos + ln].decode("utf-8", "surrogatepass"), pos + ln
    if tag == 5:
        (ln,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        out = []
        for _ in range(ln):
            v, pos = _dec_value(buf, pos)
            out.append(v)
        return tuple(out), pos
    raise ValueError(f"corrupt dictionary value tag {tag}")


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))

    def take_bytes(self) -> bytes:
        (n,) = self.unpack("<q")
        return self.take(n)


def _encode_ints(data: np.ndarray) -> tuple[int, bytes]:
    """Pick RLE when runs dominate, else delta-varint."""
    as64 = data.astype(np.int64)
    n = len(as64)
    if n == 0:
        return _ENC_VARINT, b""
    runs = int(np.count_nonzero(np.diff(as64))) + 1
    if runs * 4 <= n:
        return _ENC_RLE, rle_encode(as64)
    return _ENC_VARINT, varint_encode(as64)


def serialize_batch(batch: Batch, compress: bool = True) -> bytes:
    """Batch -> wire bytes. Selection is applied (compact first)."""
    batch = batch.compact()
    n = batch.num_rows
    parts: list[bytes] = []
    for c in batch.columns:
        data, valid = c.to_numpy()
        ty = str(c.type)
        parts.append(_pack_bytes(ty.encode()))
        has_valid = 0 if bool(valid.all()) else 1
        has_dict = 1 if c.dictionary is not None else 0
        # wide DECIMAL columns ((n, 2) int64 hi/lo lanes) ship as two
        # consecutive lane encodings
        is_wide = 1 if data.ndim == 2 else 0
        parts.append(struct.pack("<bbb", has_valid, has_dict, is_wide))
        if has_valid:
            parts.append(_pack_bytes(bitpack_encode(valid.astype(np.uint64), 1)))
        if has_dict:
            blob = b"".join(_enc_value(v) for v in c.dictionary.values)
            parts.append(struct.pack("<q", len(c.dictionary.values)))
            parts.append(_pack_bytes(blob))
        lanes = [data[:, 0], data[:, 1]] if is_wide else [data]
        for lane in lanes:
            if lane.dtype == np.bool_:
                parts.append(struct.pack("<b", _ENC_BOOL))
                parts.append(_pack_bytes(bitpack_encode(lane.astype(np.uint64), 1)))
            elif lane.dtype.kind == "f":
                parts.append(struct.pack("<b", _ENC_PLAIN))
                parts.append(_pack_bytes(np.ascontiguousarray(lane).tobytes()))
            else:
                enc, payload = _encode_ints(lane)
                parts.append(struct.pack("<b", enc))
                parts.append(_pack_bytes(payload))
    body = b"".join(parts)
    codec = _CODEC_LZ
    compressed = lz_compress(body) if compress else body
    if not compress:
        codec = 0xFF  # uncompressed marker
    header = struct.pack(
        "<IBBqqQ", PAGES_MAGIC, PAGES_VERSION, codec, n, len(batch.columns), len(body)
    )
    return header + compressed


def deserialize_batch(data: bytes) -> Batch:
    r = _Reader(data)
    magic, version, codec, n, ncols, raw_len = r.unpack("<IBBqqQ")
    if magic != PAGES_MAGIC:
        raise ValueError(f"bad pages magic: {magic:#x}")
    if version != PAGES_VERSION:
        raise ValueError(
            f"pages format v{version} (expected v{PAGES_VERSION}) — "
            "table was written by an incompatible build"
        )
    payload = r.data[r.pos :]
    if codec == 0xFF:
        body = payload
    elif codec == _CODEC_LZ:
        # ratio bound of the format: a 3-byte match token expands to <=131
        # bytes (~44x); a corrupt header can't force a huge allocation
        if raw_len > len(payload) * 64 + 1024:
            raise ValueError(f"implausible page raw length {raw_len}")
        body = lz_decompress(payload, raw_len)
    elif codec == _CODEC_ZLIB:
        import zlib

        body = zlib.decompress(payload)
    else:
        raise ValueError(f"unknown codec {codec}")
    br = _Reader(body)
    cols: list[Column] = []
    for _ in range(ncols):
        ty = T.parse_type(br.take_bytes().decode())
        has_valid, has_dict, is_wide = br.unpack("<bbb")
        valid: Optional[np.ndarray] = None
        if has_valid:
            valid = bitpack_decode(br.take_bytes(), n, 1).astype(np.bool_)
        dictionary = None
        if has_dict:
            (dict_len,) = br.unpack("<q")
            blob = br.take_bytes()
            values = []
            pos = 0
            for _ in range(dict_len):
                v, pos = _dec_value(blob, pos)
                values.append(v)
            dictionary = Dictionary(values)
        dtype = ty.storage_dtype
        lanes = []
        for _lane in range(2 if is_wide else 1):
            (enc,) = br.unpack("<b")
            payload = br.take_bytes()
            if enc == _ENC_BOOL:
                data_arr = bitpack_decode(payload, n, 1).astype(np.bool_)
            elif enc == _ENC_PLAIN:
                data_arr = np.frombuffer(payload, dtype=dtype).copy()
            elif enc == _ENC_RLE:
                data_arr = rle_decode(payload, n).astype(dtype)
            else:
                data_arr = varint_decode(payload, n).astype(dtype)
            lanes.append(data_arr.astype(dtype))
        data_out = np.stack(lanes, axis=1) if is_wide else lanes[0]
        cols.append(Column(
            ty, as_tensor(data_out),
            None if valid is None else as_tensor(valid), dictionary,
        ))
    return Batch(cols, n)
