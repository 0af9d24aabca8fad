"""Native (C++) CSV writer tier: byte parity with the Python writers.

The native tier exists for throughput (Python's csv module costs seconds
per 500k-agent values CSV and bounds the async output worker); these tests
pin that its output is byte-identical, so the fast path can never change
the on-disk format the reference's consumers parse (reference ``simulation.py:300-347`` /
``cell_outputs.py:102-127``).
"""

import csv
import ctypes
import os

import numpy as np
import pytest

from hipsc_abm import native
from hipsc_abm.utils import io as io_utils


def _lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


def python_values_csv(path, arrays, order):
    header, data = [], []
    for name in order:
        a = np.asarray(arrays[name])
        if a.ndim == 1:
            header.append(name)
            a = a.reshape(-1, 1)
        else:
            header.extend(f"{name}[{i}]" for i in range(a.shape[1]))
        data.append(a)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(np.hstack(data))


def test_fmt_repr_matches_python_repr():
    """Property test over adversarial + random float64 bit patterns: the
    C++ formatter must reproduce repr(float) exactly (same shortest digits,
    same fixed/scientific placement, same exponent spelling)."""
    lib = _lib()
    buf = ctypes.create_string_buffer(64)
    rng = np.random.default_rng(7)

    specials = [
        0.0, -0.0, 1.0, -1.0, 0.1, 1e-7, 1e20, 123456.789, 5.0, 1e16,
        9.999999999999999e15, 1e15, 0.0001, 1e-5, 0.001, 2.0**-1074,
        1.7976931348623157e308, float("inf"), float("-inf"), float("nan"),
        1800.0, 36.0, -0.360562, 1.0737418e9,
    ]
    vals = np.array(specials, dtype=np.float64)
    for v in vals:
        n = lib.hipsc_fmt_repr(float(v), buf)
        assert buf.raw[:n].decode() == str(np.float64(v)), v

    # random bit patterns (finite only), plus float32-upcasts (the values
    # CSV's actual distribution) and small ints
    bits = rng.integers(0, 2**64, 20000, dtype=np.uint64)
    rand = bits.view(np.float64)
    rand = rand[np.isfinite(rand)]
    f32 = rng.random(5000, dtype=np.float32).astype(np.float64) * 1e6
    ints = rng.integers(-(2**31), 2**31, 5000).astype(np.float64)
    for v in np.concatenate([rand, f32, ints]):
        n = lib.hipsc_fmt_repr(float(v), buf)
        got = buf.raw[:n].decode()
        want = str(np.float64(v))
        assert got == want, (v.hex(), got, want)


def test_values_csv_byte_parity(tmp_path):
    _lib()
    rng = np.random.default_rng(3)
    n = 997
    arrays = {
        "locations": (rng.random((n, 3)).astype(np.float32) * 2000),
        "radii": np.full(n, 5.0, np.float32),
        "FGF4": rng.integers(0, 2, n).astype(np.int32),
        "div_counters": rng.integers(0, 80, n).astype(np.int32),
        "ids": np.arange(n, dtype=np.int32),
    }
    order = list(arrays)
    p_native = tmp_path / "native.csv"
    p_python = tmp_path / "python.csv"
    io_utils.write_values_csv(str(p_native), arrays, order)
    python_values_csv(str(p_python), arrays, order)
    assert p_native.read_bytes() == p_python.read_bytes()


def test_values_csv_fallback_when_disabled(tmp_path, monkeypatch):
    """HIPSC_NO_NATIVE_IO forces the Python writer; output is identical, so
    an environment without g++ silently degrades instead of breaking."""
    rng = np.random.default_rng(4)
    arrays = {"x": rng.random(50).astype(np.float32),
              "k": rng.integers(0, 9, 50).astype(np.int32)}
    pa = tmp_path / "a.csv"
    pb = tmp_path / "b.csv"
    io_utils.write_values_csv(str(pa), arrays, ["x", "k"])
    monkeypatch.setenv("HIPSC_NO_NATIVE_IO", "1")
    io_utils.write_values_csv(str(pb), arrays, ["x", "k"])
    assert pa.read_bytes() == pb.read_bytes()


def test_all_int_arrays_use_python_path(tmp_path):
    """All-integer arrays hstack to an int dtype whose str() has no '.0' —
    the native float64 writer must decline rather than change the bytes."""
    arrays = {"a": np.arange(7, dtype=np.int32),
              "b": np.arange(7, dtype=np.int64) * 3}
    p = tmp_path / "ints.csv"
    io_utils.write_values_csv(str(p), arrays, ["a", "b"])
    q = tmp_path / "ints_py.csv"
    python_values_csv(str(q), arrays, ["a", "b"])
    assert p.read_bytes() == q.read_bytes()
    assert b"0,0" in p.read_bytes()  # no '.0' suffix on int rows


def test_matrix_e18_matches_savetxt(tmp_path):
    _lib()
    rng = np.random.default_rng(5)
    mats = [
        rng.random((311, 2)).astype(np.float32) * 2000,
        rng.standard_normal((40, 7)) * np.logspace(-20, 20, 7),
        np.zeros((3, 2)),
        np.empty((0, 2)),
    ]
    for i, m in enumerate(mats):
        pa = tmp_path / f"n{i}.csv"
        pb = tmp_path / f"p{i}.csv"
        io_utils._savetxt_csv(str(pa), np.asarray(m))
        np.savetxt(pb, m, delimiter=",")
        assert pa.read_bytes() == pb.read_bytes(), i


def test_tda_and_gradient_writers_still_work(tmp_path):
    rng = np.random.default_rng(6)
    n = 60
    locs = rng.random((n, 3)).astype(np.float32) * 100
    g6 = rng.integers(0, 2, n).astype(np.int32)
    ng = rng.integers(0, 2, n).astype(np.int32)
    io_utils.write_tda_csvs(str(tmp_path), "t", 1, locs, g6, ng)
    for key in ("red", "green", "all"):
        f = tmp_path / key / f"t_tda_{key}_1.csv"
        assert f.exists()
    rows = np.loadtxt(tmp_path / "all" / "t_tda_all_1.csv", delimiter=",")
    np.testing.assert_allclose(rows, locs[:, :2], rtol=1e-15)
    io_utils.write_gradient_csvs(str(tmp_path), "t", 1, {"fgf4": rng.random((9, 9))})
    assert (tmp_path / "fgf4" / "t_fgf4_1.csv").exists()


@pytest.mark.parametrize("nrows", [0, 1, 2, 5, 9, 17, 33])
def test_matrix_e18_chunking_matches_savetxt(tmp_path, nrows):
    """Row counts that leave the writer's last ceil-division chunks empty
    (e.g. 9 rows over 8 threads) must write, not abort the process."""
    _lib()
    m = np.random.default_rng(nrows).standard_normal((nrows, 2)) * 1e3
    pa, pb = tmp_path / "native.csv", tmp_path / "numpy.csv"
    assert io_utils._native_savetxt_e18(str(pa), m)
    np.savetxt(pb, m, fmt="%.18e", delimiter=",")
    assert pa.read_bytes() == pb.read_bytes()


def test_png_encoder_round_trips(tmp_path):
    """The standard-library PNG encoder (used when cv2 is absent) writes a
    valid 8-bit RGB PNG whose pixels decode back to the BGR input."""
    import struct
    import zlib

    img = np.random.default_rng(0).integers(0, 256, (7, 11, 3), dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(io_utils.encode_png(img))
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF, tag
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + length
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (w, h, depth, color) == (11, 7, 8, 2) and b"IEND" in chunks
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    np.testing.assert_array_equal(raw[:, 1:].reshape(h, w, 3)[:, :, ::-1], img)
    try:
        import cv2
    except ImportError:
        return
    np.testing.assert_array_equal(cv2.imread(str(path)), img)
