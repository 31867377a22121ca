"""Image IO: skybox loading, PNG stills and PNG frame sequences (port of
relativisticraytracer_tpu.io.image).

The JAX package writes and reads PNG through Pillow. The port writes PNG
with the standard library (`zlib` + `struct`: IHDR, an optional `tEXt`
chunk, IDAT with filter 0, IEND) and reads it with Pillow where Pillow
imports, else with a standard-library decoder for 8-bit non-interlaced
gray, RGB and RGBA, so that no part of the runtime but the JPEG preview
needs Pillow. The decoded image is RGBA8, matching the reference's forced
4-channel load (main.cpp:240)."""

from __future__ import annotations

import os
import pathlib
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (8-bit samples): gray, RGB, RGBA
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(frame: np.ndarray, text: Optional[Dict[str, str]] = None) -> bytes:
    """uint8 [H, W, 3 or 4] -> PNG bytes, every row with filter 0; `text`
    adds one tEXt chunk per key."""
    a = np.ascontiguousarray(frame, dtype=np.uint8)
    if a.ndim != 3 or a.shape[2] not in (3, 4):
        raise ValueError(f"cannot write a PNG of shape {a.shape}: expected [H, W, 3 or 4]")
    h, w, c = a.shape
    color = 2 if c == 3 else 6
    raw = np.zeros((h, 1 + w * c), np.uint8)  # column 0: filter type 0
    raw[:, 1:] = a.reshape(h, w * c)
    out = [_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))]
    for key, value in (text or {}).items():
        out.append(_chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1")))
    out.append(_chunk(b"IDAT", zlib.compress(raw.tobytes())))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def _read_chunks(path) -> Tuple[dict, Dict[str, str], bytes]:
    """(IHDR fields, tEXt entries, concatenated IDAT) of a PNG file."""
    data = pathlib.Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, text, idat = len(_SIGNATURE), None, {}, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
            header = dict(width=w, height=h, depth=depth, color=color, interlace=interlace)
        elif kind == b"tEXt":
            key, _, value = body.partition(b"\0")
            text[key.decode("latin-1")] = value.decode("latin-1")
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    return header, text, b"".join(idat)


def png_info(path) -> Tuple[Tuple[int, int], Dict[str, str]]:
    """((width, height), tEXt entries) of a PNG file, without decoding it."""
    header, text, _ = _read_chunks(path)
    return (header["width"], header["height"]), text


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_png(path) -> np.ndarray:
    """Standard-library decoder: 8-bit, non-interlaced gray, RGB or RGBA
    PNG -> uint8 [H, W, 4]."""
    header, _, idat = _read_chunks(path)
    w, h, color = header["width"], header["height"], header["color"]
    if header["depth"] != 8 or color not in _CHANNELS or header["interlace"]:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB/RGBA PNGs decode "
                         f"without Pillow (got {header})")
    c = _CHANNELS[color]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    img = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, line = rows[y, 0], rows[y, 1:]
        if f == 0:
            cur = line.copy()
        elif f == 2:  # Up
            cur = line + prev
        elif f == 1:  # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(w, c), axis=0, dtype=np.uint8).reshape(stride)
        elif f in (3, 4):  # Average, Paeth: each byte needs the decoded one before it
            cur = bytearray(line.tobytes())
            up = prev.tolist()
            for i in range(stride):
                left = cur[i - c] if i >= c else 0
                if f == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - c] if i >= c else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: bad PNG filter type {f}")
        img[y] = cur
        prev = img[y]
    img = img.reshape(h, w, c)
    if c == 4:
        return img
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = img[..., :1] if c == 1 else img
    return out


def load_image_rgba(path: str) -> np.ndarray:
    """Decode an image to uint8 [H, W, 4]: any Pillow-supported format
    where Pillow imports, else 8-bit non-interlaced PNG (decode_png)."""
    try:
        from PIL import Image
    except ImportError:
        return decode_png(path)
    with Image.open(path) as img:
        return np.asarray(img.convert("RGBA"), dtype=np.uint8)


def load_skybox(path: Optional[str] = None, fallback_shape=(1024, 2048),
                device="cuda") -> np.ndarray:
    """Load an equirect skybox image; if `path` is None or unreadable,
    return the deterministic procedural starfield, built on `device` (the
    reference ships a JPEG asset we do not copy; any 2:1 equirect image
    drops in). Mirrors the reference's continue-on-failure behavior
    (main.cpp:241-244)."""
    if path is not None:
        try:
            return load_image_rgba(path)
        except Exception:  # noqa: BLE001 — any unreadable file falls back, as in the reference
            pass
    from relativisticraytracer_tpu_torch.render.skybox import procedural_starfield

    return procedural_starfield(*fallback_shape, device=device)


def save_png(path: str, frame: np.ndarray) -> None:
    """Write a uint8 [H, W, 3or4] frame as PNG."""
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(path).write_bytes(encode_png(np.asarray(frame)))


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
            size, text = png_info(first)
            if size != (self.width, self.height):
                raise ValueError(
                    f"cannot resume into {self.dir}: existing frames are "
                    f"{size[0]}x{size[1]}, this run renders "
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
