"""The port's native host codecs and pages serde against the JAX reference's,
on the CPU.

Every entry point of ``trino_tpu_torch/csrc/columnar.cpp`` gives the bytes
of the reference's ``native/columnar.cpp`` on the same seeded inputs, and
each NumPy version (``native.decode_mode(False)``) gives the native one's.
The pages serde writes the reference's bytes for the same batch and each
package reads the other's pages.
"""

import threading

import numpy as np
import pytest
import torch

from trino_tpu import native as ref_native
from trino_tpu import serde as ref_serde
from trino_tpu import types as RT
from trino_tpu import columnar as RC
from trino_tpu.formats import orc as ref_orc
from trino_tpu_torch import native, serde
from trino_tpu_torch import types as T
from trino_tpu_torch.columnar import batch_from_numpy
from trino_tpu_torch.formats import orc

torch.set_num_threads(1)

RNG_SEED = 11


def _ints(kind: str, n: int = 3000) -> np.ndarray:
    rng = np.random.default_rng(RNG_SEED)
    if kind == "small":
        return rng.integers(-50, 50, n)
    if kind == "runs":
        return np.repeat(rng.integers(-(1 << 40), 1 << 40, n // 30), 30)
    if kind == "sorted":
        return np.cumsum(rng.integers(0, 1000, n))
    if kind == "extremes":
        return np.array([np.iinfo(np.int64).min, -1, 0, 1, np.iinfo(np.int64).max] * 7)
    return rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n)


INT_KINDS = ["small", "runs", "sorted", "extremes", "wide"]


def both(fn, *args):
    """``fn`` natively and through its NumPy version."""
    got = fn(*args)
    with native.decode_mode(False):
        slow = fn(*args)
    return got, slow


def _bytes(kind: str) -> bytes:
    rng = np.random.default_rng(RNG_SEED)
    if kind == "text":
        words = [b"alpha", b"beta", b"gamma", b"delta ", b"\xc3\xa4"]
        return b"".join(words[i] for i in rng.integers(0, 5, 4000))
    if kind == "random":
        return rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    if kind == "zeros":
        return bytes(70000)
    return b"abc"


@pytest.mark.parametrize("kind", INT_KINDS)
@pytest.mark.parametrize("codec", ["varint", "rle"])
def test_integer_codecs_equal_the_reference(codec, kind):
    vals = _ints(kind)
    enc = getattr(native, f"{codec}_encode")
    dec = getattr(native, f"{codec}_decode")
    got, slow = both(enc, vals)
    assert got == getattr(ref_native, f"{codec}_encode")(vals) == slow
    back, back_slow = both(dec, got, len(vals))
    np.testing.assert_array_equal(back, vals)
    np.testing.assert_array_equal(back_slow, vals)
    np.testing.assert_array_equal(getattr(ref_native, f"{codec}_decode")(got, len(vals)), vals)


@pytest.mark.parametrize("width", [1, 3, 17, 64])
def test_bitpack_equals_the_reference(width):
    rng = np.random.default_rng(RNG_SEED)
    top = (1 << width) - 1 if width < 64 else np.iinfo(np.uint64).max
    vals = rng.integers(0, top, 999, dtype=np.uint64, endpoint=True)
    got, slow = both(native.bitpack_encode, vals, width)
    assert got == ref_native.bitpack_encode(vals, width) == slow
    back, back_slow = both(native.bitpack_decode, got, len(vals), width)
    np.testing.assert_array_equal(back, vals)
    np.testing.assert_array_equal(back_slow, vals)


@pytest.mark.parametrize("kind", ["text", "random", "zeros", "short"])
def test_byte_compressors_equal_the_reference(kind):
    data = _bytes(kind)
    lz, lz_slow = both(native.lz_compress, data)
    assert lz == ref_native.lz_compress(data) == lz_slow  # the reference's own is zlib
    for blob in (lz, ref_native.lz_compress(data)):
        back, back_slow = both(native.lz_decompress, blob, len(data))
        assert back == back_slow == data
    sn, sn_slow = both(native.snappy_compress, data)
    assert sn == ref_native.snappy_compress(data) == sn_slow
    back, back_slow = both(native.snappy_decompress, sn, len(data))
    assert back == back_slow == ref_native.snappy_decompress(sn, len(data)) == data


def test_snappy_decoder_reads_copy_tags():
    """A stream with 1-, 2- and 4-byte-offset copies (the literal-only
    writer makes none)."""
    body = b"abcdefgh"
    stream = bytes([40])  # uncompressed length 40
    stream += bytes([(8 - 1) << 2]) + body  # literal
    stream += bytes([0b001 | ((8 - 4) << 2), 8])  # 1-byte offset copy, len 8
    stream += bytes([0b10 | ((8 - 1) << 2)]) + (16).to_bytes(2, "little")
    stream += bytes([0b11 | ((16 - 1) << 2)]) + (24).to_bytes(4, "little")
    got, slow = both(native.snappy_decompress, stream, 40)
    assert got == slow == ref_native.snappy_decompress(stream, 40) == body * 5


@pytest.mark.parametrize("width", [1, 3, 8, 20, 32])
def test_parquet_hybrid_equals_the_reference(width):
    rng = np.random.default_rng(RNG_SEED)
    vals = np.repeat(rng.integers(0, 1 << min(width, 31), 200), rng.integers(1, 9, 200)).astype(np.int32)
    got, slow = both(native.parquet_rle_encode, vals, width)
    assert got == ref_native.parquet_rle_encode(vals, width) == slow
    back, back_slow = both(native.parquet_rle_decode, got, width, len(vals))
    np.testing.assert_array_equal(back, vals)
    np.testing.assert_array_equal(back_slow, vals)
    # a bit-packed run (header bit 0 set): 2 groups of 8 values
    packed = native.bitpack_encode(vals[:16].astype(np.uint64) & np.uint64((1 << width) - 1), width)
    stream = bytes([(2 << 1) | 1]) + packed
    want = ref_native.parquet_rle_decode(stream, width, 16)
    got, slow = both(native.parquet_rle_decode, stream, width, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(slow, want)


@pytest.mark.parametrize("kind", INT_KINDS)
@pytest.mark.parametrize("signed", [True, False])
def test_orc_integer_streams_equal_the_reference(kind, signed):
    vals = _ints(kind)
    if not signed:
        vals = np.abs(vals[vals > np.iinfo(np.int64).min])
    enc = native.orc_rle2_encode(vals, signed)
    assert enc == ref_native.orc_rle2_encode(vals, signed)
    with native.decode_mode(False):
        assert native.orc_rle2_encode(vals, signed) is None  # formats/orc.py encodes
        slow_enc = orc._rle_v2_encode(vals, signed)
        slow = orc._rle_v2(enc, len(vals), signed)
    assert slow_enc == ref_orc._rle_v2_encode(vals, signed)
    np.testing.assert_array_equal(native.orc_rle2(enc, len(vals), signed), vals)
    np.testing.assert_array_equal(slow, vals)
    np.testing.assert_array_equal(ref_native.orc_rle2(slow_enc, len(vals), signed), vals)
    # RLEv1 (read only): the reference's Python writer of runs and literals
    head = vals[:500]
    v1 = _rle_v1_encode(head, signed)
    want = ref_native.orc_rle1(v1, len(head), signed)
    got = native.orc_rle1(v1, len(head), signed)
    with native.decode_mode(False):
        slow = orc._rle_v1(v1, len(head), signed)
    np.testing.assert_array_equal(want, head)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(slow, want)


def _rle_v1_encode(vals, signed: bool) -> bytes:
    """ORC RLEv1: a literal group of up to 128 varints a header byte."""
    out = bytearray()
    for lo in range(0, len(vals), 128):
        chunk = vals[lo : lo + 128]
        out.append(256 - len(chunk))
        for x in chunk.tolist():
            u = ((x << 1) ^ (x >> 63)) & ((1 << 64) - 1) if signed else x
            while u >= 0x80:
                out.append((u & 0x7F) | 0x80)
                u >>= 7
            out.append(u)
    return bytes(out)


@pytest.mark.parametrize("kind", ["runs", "random", "constant"])
def test_orc_byte_streams_equal_the_reference(kind):
    rng = np.random.default_rng(RNG_SEED)
    if kind == "runs":
        b = np.repeat(rng.integers(0, 256, 300, dtype=np.uint8), rng.integers(1, 200, 300))
    elif kind == "random":
        b = rng.integers(0, 256, 1000, dtype=np.uint8)
    else:
        b = np.full(1000, 7, np.uint8)
    enc = native.orc_byte_rle_encode(b)
    assert enc == ref_native.orc_byte_rle_encode(b)
    with native.decode_mode(False):
        assert orc._byte_rle_encode(b) == ref_orc._byte_rle_encode(b)
        slow = orc._byte_rle(enc, len(b))
    np.testing.assert_array_equal(native.orc_byte_rle(enc, len(b)), b)
    np.testing.assert_array_equal(slow, b)


def test_orc_decimal_and_varint_streams_equal_the_reference():
    vals = _ints("wide", 500) // 7
    u = orc._zigzag_encode_np(vals)
    enc = native.orc_varint_encode(u)
    assert enc == ref_native.orc_varint_encode(u)
    with native.decode_mode(False):
        assert orc._varints_bytes(u) == enc
        slow = orc._decimal_varints(enc, len(vals))
    np.testing.assert_array_equal(native.orc_decimal64(enc, len(vals)), vals)
    np.testing.assert_array_equal(ref_native.orc_decimal64(enc, len(vals)), vals)
    np.testing.assert_array_equal(slow, vals)


def test_staging_layouts_equal_the_reference():
    rng = np.random.default_rng(RNG_SEED)
    arrays = [rng.integers(0, 1 << 30, 37), rng.random(5), np.arange(3) % 2 == 0,
              rng.integers(0, 9, 11).astype(np.int16), np.zeros(0, np.int64)]
    arena, slow = both(native.pack_arena, arrays)
    np.testing.assert_array_equal(arena, ref_native.pack_arena(arrays))
    np.testing.assert_array_equal(slow, arena)
    offsets = [0, 304, 352, 360, 384]
    bufs = []
    for mode in (True, False):
        buf = np.full(400, 0xAB, np.uint8)
        with native.decode_mode(mode):
            native.scatter_segments(arrays, offsets, buf.ctypes.data, len(buf))
        bufs.append(buf)
    np.testing.assert_array_equal(bufs[0], bufs[1])
    assert bufs[0][296:304].tolist() == [0] * 8  # the gaps are zeroed
    np.testing.assert_array_equal(bufs[0][:296].view(np.int64), arrays[0])
    with pytest.raises(ValueError):
        native.scatter_segments(arrays, [0, 8, 16, 24, 32], buf.ctypes.data, len(buf))


def test_dict_encode_numpy_version_equals_the_native_one():
    strings = [f"s{i % 37}" for i in range(500)] + ["", "ä"]
    (codes, values), (slow_codes, slow_values) = both(native.dict_encode, strings)
    np.testing.assert_array_equal(codes, slow_codes)
    assert values == slow_values


def test_decode_mode_is_per_thread():
    """A thread that selects the NumPy versions leaves every other thread
    on the native ones (the reference's ``python_fallback`` swaps the
    module handle for all of them)."""
    seen, inside, leave = {}, threading.Event(), threading.Event()

    def numpy_thread():
        with native.decode_mode(False):
            seen["numpy"] = native.native_mode()
            inside.set()
            leave.wait(5)

    t = threading.Thread(target=numpy_thread)
    t.start()
    inside.wait(5)
    seen["main"] = native.native_mode()
    leave.set()
    t.join()
    assert seen == {"numpy": False, "main": True}
    assert native.native_mode()


def _batch(pkg):
    rng = np.random.default_rng(RNG_SEED)
    n = 400
    types = ["bigint", "integer", "double", "boolean", "varchar", "date", "decimal(12,2)"]
    arrays = [
        np.cumsum(rng.integers(0, 5, n)), rng.integers(-9, 9, n), rng.random(n),
        rng.random(n) < 0.5, np.array([f"v{int(i)}" for i in rng.integers(0, 20, n)]),
        rng.integers(8000, 9000, n), np.repeat(rng.integers(0, 10**9, n // 40), 40),
    ]
    valids = [None, rng.random(n) < 0.8, None, None, rng.random(n) < 0.9, None, None]
    if pkg == "port":
        return batch_from_numpy([T.parse_type(t) for t in types], arrays, valids)
    return ref_batch([RT.parse_type(t) for t in types], arrays, valids)


def ref_batch(types, arrays, valids=None):
    """The reference's host batch of numpy columns (strings encoded
    through its dictionary)."""
    valids = valids or [None] * len(arrays)
    cols = []
    for t, a, v in zip(types, arrays, valids):
        d = None
        if RT.is_string(t):
            d, a = RC.Dictionary.from_strings([str(x) for x in a])
        cols.append(RC.Column(t, np.asarray(a).astype(t.storage_dtype), v, d))
    return RC.Batch(cols, len(arrays[0]))


@pytest.mark.parametrize("compress", [True, False])
def test_pages_serde_equals_the_reference(compress):
    ours, ref = _batch("port"), _batch("ref")
    blob = serde.serialize_batch(ours, compress=compress)
    assert blob == ref_serde.serialize_batch(ref, compress=compress)
    with native.decode_mode(False):
        assert serde.serialize_batch(ours, compress=compress) == blob
        slow = serde.deserialize_batch(blob).to_pylist()
    assert serde.deserialize_batch(blob).to_pylist() == ref.to_pylist() == slow
    assert ref_serde.deserialize_batch(blob).to_pylist() == ours.to_pylist()


def test_pages_serde_reads_zlib_pages_and_wide_decimals():
    """A page the reference writes without its native library (tagged
    zlib) and a DECIMAL(38) column of (hi, lo) lanes."""
    import struct
    import zlib

    ref = _batch("ref")
    raw = ref_serde.serialize_batch(ref, compress=False)
    head = struct.calcsize("<IBBqqQ")
    fields = list(struct.unpack("<IBBqqQ", raw[:head]))
    fields[2] = ref_serde._CODEC_ZLIB
    page = struct.pack("<IBBqqQ", *fields) + zlib.compress(raw[head:])
    assert serde.deserialize_batch(page).to_pylist() == ref.to_pylist()
    wide = T.decimal(38, 2)
    vals = np.array([[0, 5], [-1, -7], [3, 0]], dtype=np.int64)
    from trino_tpu_torch.columnar import Batch, Column

    b = Batch([Column(wide, torch.from_numpy(vals))], 3)
    back = serde.deserialize_batch(serde.serialize_batch(b))
    assert back.to_pylist() == b.to_pylist()
    assert back.columns[0].data.shape == (3, 2)
