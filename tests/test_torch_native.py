"""trino_tpu_torch's native loader against the JAX reference's, on the CPU.

The port builds its own ``trino_tpu_torch/csrc/columnar.cpp`` with ``g++``,
into ``.kernel_build/native/``: the TPC-H text pool it generates equals
the reference's byte for byte, and its dictionary encoder gives the
reference's codes and values. Unlike the reference it has no Python
fallback, so a compiler that fails raises with the compiler's stderr.
"""

import stat

import numpy as np
import pytest

from trino_tpu import native as ref_native
from trino_tpu.connectors import dbgen as ref_dbgen
from trino_tpu_torch import native
from trino_tpu_torch.connectors import dbgen


def test_loader_builds_into_the_port_build_directory():
    lib = native.load()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == (".kernel_build", "native")
    assert native.load() is lib  # built and loaded once


def test_text_pool_equals_the_reference_pool():
    got, want = dbgen.text_pool(), ref_dbgen.text_pool()
    assert got.shape == want.shape == (dbgen.TEXT_POOL_SIZE,)
    assert np.array_equal(got, want)
    assert dbgen.text_pool() is got  # memory-mapped once


def test_text_pool_generation_equals_the_python_version():
    """The native generator against the pure-Python one, on the first
    64 KiB (the Python version takes minutes for the whole pool)."""
    blob = dbgen.dists_blob()
    n = 1 << 16
    got = native.tpch_textpool(n, blob, dbgen.S_TEXT_POOL)
    assert np.array_equal(got, dbgen.textpool_python(n, blob, dbgen.S_TEXT_POOL))


@pytest.mark.parametrize("case", ["words", "unicode", "empty-and-dups", "none"])
def test_dict_encode_equals_the_reference(case):
    rng = np.random.default_rng(5)
    if case == "words":
        strings = [f"w{int(x)}" for x in rng.integers(0, 300, 5000)]
    elif case == "unicode":
        strings = [["ä", "日本", "\U0001F600", "a", "ä "][int(x)]
                   for x in rng.integers(0, 5, 1000)]
    elif case == "empty-and-dups":
        strings = ["", "x", "", "x", "y", ""]
    else:
        strings = []
    codes, values = native.dict_encode(strings)
    want_codes, want_values = ref_native.dict_encode(strings)
    assert codes.dtype == np.int32
    np.testing.assert_array_equal(codes, want_codes)
    assert values == list(want_values)
    assert [values[c] for c in codes] == strings


def test_failing_compiler_raises_with_its_stderr(tmp_path, monkeypatch):
    fake = tmp_path / "fake-g++"
    fake.write_text("#!/bin/sh\necho 'fatal: no compiler here' >&2\nexit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "CXX", str(fake))
    with pytest.raises(native.NativeCompileError, match="no compiler here"):
        native.load()
    monkeypatch.setattr(native, "CXX", str(tmp_path / "missing-g++"))
    with pytest.raises(native.NativeCompileError, match="could not run"):
        native.dict_encode(["a"])
