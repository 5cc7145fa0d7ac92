"""The standard-library PNG writer and reader (io/image.py): stills and
frame sequences need no imaging package; Pillow stays optional."""

import struct
import sys
import zlib

import numpy as np
import pytest

from relativisticraytracer_tpu.io import image
from relativisticraytracer_tpu.io.image import (
    FrameSequenceWriter,
    decode_png,
    encode_png,
    load_image_rgba,
    load_skybox,
    png_info,
    save_png,
)


@pytest.fixture
def no_pillow(monkeypatch):
    """Make `import PIL` fail, as on a machine without Pillow."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip(rng, tmp_path, channels):
    frame = rng.integers(0, 256, (13, 17, channels), dtype=np.uint8)
    save_png(str(tmp_path / "f.png"), frame)
    back = decode_png((tmp_path / "f.png").read_bytes())
    np.testing.assert_array_equal(back[..., :channels], frame)
    if channels == 3:
        assert (back[..., 3] == 255).all()


def test_png_text_chunks_and_info(rng, tmp_path):
    frame = rng.integers(0, 256, (5, 9, 4), dtype=np.uint8)
    save_png(str(tmp_path / "f.png"), frame, text={"rrt_fps": "24"})
    assert png_info(str(tmp_path / "f.png")) == (9, 5, {"rrt_fps": "24"})


def _encode_filtered(img: np.ndarray, kind: int) -> bytes:
    """A PNG whose every scanline uses filter `kind` (0-4)."""
    h, w, c = img.shape
    rows, prev = [], np.zeros((w, c), np.int32)
    zero = np.zeros((1, c), np.int32)
    for y in range(h):
        cur = img[y].astype(np.int32)
        left = np.vstack([zero, cur[:-1]])
        upleft = np.vstack([zero, prev[:-1]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(k, d):
        return struct.pack(">I", len(d)) + k + d + struct.pack(
            ">I", zlib.crc32(k + d) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
def test_png_decodes_every_filter_type(rng, kind):
    img = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        decode_png(_encode_filtered(img, kind))[..., :3], img)


def test_png_rejects_unsupported_kinds():
    data = bytearray(encode_png(np.zeros((2, 2, 3), np.uint8)))
    data[24] = 16  # IHDR bit depth -> 16
    with pytest.raises(ValueError, match="unsupported PNG"):
        decode_png(bytes(data))


def test_frame_sequence_without_pillow(no_pillow, rng, tmp_path):
    """Writing frames and the geometry/fps checks on resume use only the
    standard library."""
    frame = rng.integers(0, 256, (6, 8, 4), dtype=np.uint8)
    seq = FrameSequenceWriter(str(tmp_path), 8, 6, fps=24)
    assert seq.resume() == 0
    seq.capture(frame)
    seq.capture(frame)
    assert FrameSequenceWriter(str(tmp_path), 8, 6, fps=24).resume() == 2
    assert png_info(str(tmp_path / "frame_00000.png"))[2] == {"rrt_fps": "24"}
    with pytest.raises(ValueError, match="fps"):
        FrameSequenceWriter(str(tmp_path), 8, 6, fps=30).resume()
    with pytest.raises(ValueError, match="8x6"):
        FrameSequenceWriter(str(tmp_path), 16, 6, fps=24).resume()


def test_skybox_decoding_without_pillow(no_pillow, rng, tmp_path):
    """Without Pillow a PNG skybox still loads; any other format is an
    ImportError naming the package, never a silent starfield."""
    sky = rng.integers(0, 256, (4, 8, 4), dtype=np.uint8)
    save_png(str(tmp_path / "sky.png"), sky)
    np.testing.assert_array_equal(load_image_rgba(str(tmp_path / "sky.png")), sky)
    (tmp_path / "sky.jpg").write_bytes(b"\xff\xd8\xff\xe0not really a jpeg")
    with pytest.raises(ImportError, match="Pillow"):
        load_skybox(str(tmp_path / "sky.jpg"))
    # an unreadable path is still the reference's continue-on-failure
    assert load_skybox(str(tmp_path / "missing.png"),
                       fallback_shape=(4, 8)).shape == (4, 8, 4)


def test_png_written_by_us_reads_in_pillow(rng):
    Image = pytest.importorskip("PIL.Image")
    import io

    frame = rng.integers(0, 256, (5, 9, 4), dtype=np.uint8)
    with Image.open(io.BytesIO(encode_png(frame, {"k": "v"}))) as im:
        np.testing.assert_array_equal(np.asarray(im), frame)
        assert im.text == {"k": "v"}
    assert image._PNG_SIGNATURE == b"\x89PNG\r\n\x1a\n"
