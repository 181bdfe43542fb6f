import numpy as np
import pytest

from pathtracer.io.exr import read_exr, write_exr
from pathtracer.scene.assets import golden_path


def test_golden_read():
    img, channels = read_exr(golden_path("cornellbox", 8))
    assert img.shape == (600, 800, 3)
    assert channels == ["R", "G", "B"]
    assert np.isfinite(img).all()
    assert 0.0 <= img.min()
    # the light patch is the brightest legitimate content (R radiance 5)
    assert img.max() >= 5.0


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("compress", [False, True])
def test_roundtrip(tmp_path, half, compress):
    rng = np.random.default_rng(42)
    img = (rng.random((41, 67, 3)) * 4.0).astype(np.float32)
    path = str(tmp_path / "rt.exr")
    write_exr(path, img, half=half, compress=compress)
    back, channels = read_exr(path)
    assert channels == ["R", "G", "B"]
    tol = 2e-3 if half else 0.0
    assert np.abs(back - img).max() <= tol


def test_roundtrip_tall_not_multiple_of_block(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((33, 8, 3)).astype(np.float32)  # 33 rows: 16+16+1
    path = str(tmp_path / "rt.exr")
    write_exr(path, img, half=False, compress=True)
    back, _ = read_exr(path)
    assert np.array_equal(back, img)


def test_decreasing_y_line_order(tmp_path):
    """Chunk y headers are absolute: a DECREASING_Y file (chunks stored
    bottom-first) must decode identically — no post-hoc flip."""
    rng = np.random.default_rng(7)
    img = rng.random((5, 9, 3)).astype(np.float32)
    path = str(tmp_path / "inc.exr")
    write_exr(path, img, half=False, compress=False)
    data = bytearray(open(path, "rb").read())

    # walk the header like the reader does to find where chunks start
    off = 8
    while True:
        end = data.index(b"\0", off)
        name = bytes(data[off:end]).decode()
        off = end + 1
        if not name:
            break
        end = data.index(b"\0", off)
        off = end + 1
        import struct

        size = struct.unpack("<i", data[off:off + 4])[0]
        off += 4
        if name == "lineOrder":
            data[off] = 1  # DECREASING_Y
        off += size
    off += 8 * img.shape[0]  # offset table
    chunks = []
    while off < len(data):
        size = struct.unpack("<i", data[off + 4:off + 8])[0]
        chunks.append(bytes(data[off:off + 8 + size]))
        off += 8 + size
    assert len(chunks) == img.shape[0]
    dec = data[: off - sum(len(c) for c in chunks)] + b"".join(chunks[::-1])
    path2 = str(tmp_path / "dec.exr")
    open(path2, "wb").write(bytes(dec))
    back, _ = read_exr(path2)
    assert np.array_equal(back, img)
