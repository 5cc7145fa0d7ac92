"""Image IO: skybox loading and PNG stills.

Replaces the reference's vendored stb_image decode + cudaArray upload
(src/main.cpp:237-266). PNGs are written and read with the standard
library alone (zlib + struct), so rendering stills and frame sequences
needs no imaging package. Pillow is an optional extra, imported only to
decode a user's non-PNG skybox (JPEG, ...). Decoded images are RGBA8,
matching the reference's forced 4-channel load (main.cpp:240)."""

from __future__ import annotations

import pathlib
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (8-bit, non-palette types only)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(frame: np.ndarray, text: Optional[Dict[str, str]] = None) -> bytes:
    """uint8 [H, W, 3or4] -> PNG bytes (8-bit RGB/RGBA, filter 0), with
    optional tEXt chunks (latin-1 keys and values)."""
    frame = np.ascontiguousarray(frame)
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] not in (3, 4):
        raise ValueError(f"expected uint8 [H, W, 3or4], got {frame.shape} {frame.dtype}")
    h, w, c = frame.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), frame.reshape(h, w * c)], axis=1)
    out = [_PNG_SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                       6 if c == 4 else 2, 0, 0, 0))]
    for key, value in (text or {}).items():
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0"
                          + str(value).encode("latin-1")))
    out.append(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def _read_chunks(data: bytes):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


def png_info(path: str) -> Tuple[int, int, Dict[str, str]]:
    """(width, height, tEXt chunks) of a PNG file, without decoding pixels."""
    data = pathlib.Path(path).read_bytes()
    w = h = None
    text: Dict[str, str] = {}
    for kind, body in _read_chunks(data):
        if kind == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif kind == b"tEXt":
            key, _, value = body.partition(b"\0")
            text[key.decode("latin-1")] = value.decode("latin-1")
    if w is None:
        raise ValueError(f"{path}: PNG without IHDR")
    return w, h, text


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (types 0-4) for 8-bit samples.
    Average and Paeth rows are sequential along x (one numpy step per
    pixel), so large images that use them decode faster through Pillow."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * c + 1)
    out = np.zeros((h, w, c), np.uint8)
    prev = np.zeros((w, c), np.int32)
    for y in range(h):
        kind = rows[y, 0]
        line = rows[y, 1:].reshape(w, c).astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line, axis=0) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):
            cur = np.zeros((w, c), np.int32)
            a = d = np.zeros(c, np.int32)
            for x in range(w):
                b = prev[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    pa, pb, pc = np.abs(b - d), np.abs(a - d), np.abs(a + b - 2 * d)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, d))
                a = cur[x] = (line[x] + pred) & 0xFF
                d = b
        else:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 4] RGBA, for 8-bit non-interlaced
    gray/RGB/gray-alpha/RGBA images (what stills and most skyboxes are);
    raises ValueError on other kinds."""
    ihdr, idat = None, []
    for kind, body in _read_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {ctype}, "
            f"interlace {interlace})")
    c = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, c)
    if c == 4:
        return px
    alpha = px[..., 1:] if c == 2 else np.full((h, w, 1), 255, np.uint8)
    rgb = px[..., :1].repeat(3, axis=2) if c in (1, 2) else px
    return np.concatenate([rgb, alpha], axis=2)


def load_image_rgba(path: str) -> np.ndarray:
    """Decode an image file to uint8 [H, W, 4] through Pillow (an optional
    dependency) when it is installed; without it, PNGs still decode with
    the standard library."""
    try:
        from PIL import Image
    except ImportError as e:
        data = pathlib.Path(path).read_bytes()
        if data[:8] == _PNG_SIGNATURE:
            return decode_png(data)
        raise ImportError(
            f"decoding {path} needs the Pillow package (pip install pillow); "
            "without it only PNG files can be read"
        ) from e
    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"), dtype=np.uint8)


def load_skybox(path: Optional[str] = None,
                fallback_shape=(1024, 2048)) -> np.ndarray:
    """Load an equirect skybox image; if `path` is None or unreadable,
    return the deterministic procedural starfield (the reference ships a
    JPEG asset we do not copy; any 2:1 equirect image drops in). Mirrors the
    reference's continue-on-failure behavior (main.cpp:241-244). A missing
    decoder (Pillow) is an error, not an unreadable file."""
    if path is not None:
        try:
            return load_image_rgba(path)
        except ImportError:
            raise
        except Exception:
            pass
    from relativisticraytracer_tpu.render.skybox import procedural_starfield

    return procedural_starfield(*fallback_shape)


def save_png(path: str, frame: np.ndarray,
             text: Optional[Dict[str, str]] = None) -> None:
    """Write a uint8 [H, W, 3or4] frame as PNG (standard library only)."""
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(path).write_bytes(encode_png(np.asarray(frame), text))


class FrameSequenceWriter:
    """PNG frame-sequence sink: `out_dir/frame_00000.png`, `..._00001.png`…

    The encoder-free animation target (compositing workflows, or hosts
    without ffmpeg where a video container is unwanted). Each frame is
    written atomically (tmp + rename), so the finished files ARE the
    checkpoint: `resume()` returns the first missing index and a killed
    job continues exactly there — no sidecar state at all.
    """

    FMT = "frame_{:05d}.png"

    def __init__(self, out_dir: str, width: int, height: int,
                 fps: Optional[int] = None):
        self.dir = pathlib.Path(out_dir)
        self.width = width
        self.height = height
        self.fps = fps
        self._next = 0

    def resume(self) -> int:
        """First missing frame index (files must be consecutive from 0).

        Refuses to resume into a directory whose existing frames were
        written at a different resolution OR recording fps (each frame
        carries an `rrt_fps` PNG text chunk; frames at another fps sit on
        a different simulation clock) — the PNG-sequence analog of
        VideoRecorder's geometry-checked sidecar."""
        self.dir.mkdir(parents=True, exist_ok=True)
        first = self.dir / self.FMT.format(0)
        if first.exists():
            w, h, text = png_info(str(first))
            if (w, h) != (self.width, self.height):
                raise ValueError(
                    f"cannot resume into {self.dir}: existing frames are "
                    f"{w}x{h}, this run renders "
                    f"{self.width}x{self.height}"
                )
            prev_fps = text.get("rrt_fps")
            if (self.fps is not None and prev_fps is not None
                    and int(prev_fps) != int(self.fps)):
                raise ValueError(
                    f"cannot resume into {self.dir}: existing frames were "
                    f"recorded at {prev_fps} fps, this run is {self.fps} — "
                    "their sim clocks differ"
                )
        k = 0
        while (self.dir / self.FMT.format(k)).exists():
            k += 1
        self._next = k
        return k

    def capture(self, frame: np.ndarray) -> None:
        import os

        if frame.shape != (self.height, self.width, 4) or frame.dtype != np.uint8:
            raise ValueError(f"bad frame {frame.shape} {frame.dtype}")
        target = self.dir / self.FMT.format(self._next)
        tmp = target.with_name(target.name + ".tmp")
        text = {"rrt_fps": str(int(self.fps))} if self.fps is not None else None
        tmp.write_bytes(encode_png(frame, text))
        os.replace(tmp, target)
        self._next += 1

    def truncate_to(self, n: int) -> int:
        """Drop frames with index >= n and clamp the next-write index.

        The PNG-sequence analog of SegmentedRecorder.truncate_to: a prior
        run with a longer duration / higher fps may have left frames
        beyond this run's count — after this, the directory holds exactly
        frames [0, min(next, n)). Returns the clamped resume index."""
        for f in self.dir.glob("frame_*.png"):
            try:
                idx = int(f.stem.split("_")[1])
            except (IndexError, ValueError):
                continue
            if idx >= n:
                f.unlink()
        self._next = min(self._next, n)
        return self._next

    def stop(self) -> int:
        return self._next

    def abort(self) -> None:
        """Nothing buffered — every captured frame is already durable."""
