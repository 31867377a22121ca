"""Video recording: frames -> FFmpeg H.264 MP4 (port of
relativisticraytracer_tpu.io.video; reference: ScreenRecorder,
src/main.cpp:29-124).

The FFmpeg command replicates the reference encode settings exactly
(main.cpp:60-72): rawvideo rgba input at RECORDING_FPS, libx264, preset
fast, CRF 18, yuv420p — EXCEPT `-vf vflip`, which the reference needs only
because glReadPixels returns bottom-up rows; our frames are already
top-down (see render/camera.py orientation note).

When no `ffmpeg` binary exists on the host, frames are written to
a raw `.rgba` file next to a `.json` sidecar containing the exact FFmpeg
command that finishes the job elsewhere.
"""

from __future__ import annotations

import datetime
import json
import os
import pathlib
import shlex
import shutil
from typing import Optional

import numpy as np

from relativisticraytracer_tpu_torch.config import RECORDING_FPS
from relativisticraytracer_tpu_torch.runtime.framesink import FrameSink


def ffmpeg_command(width: int, height: int, fps: int, out_path: str,
                   pix_fmt: str = "rgba") -> str:
    """The reference encoder line (main.cpp:61-72), minus the vflip.

    pix_fmt "yuv420p" feeds frames already converted on-device
    (render/postfx.yuv420_from_rgba8): 1.5 B/px over the link instead of 4,
    and FFmpeg skips its own swscale pass. Output encoding is identical
    (libx264 converts rgba input to yuv420p anyway)."""
    return (
        "ffmpeg -y "
        "-f rawvideo "
        f"-pix_fmt {pix_fmt} "
        f"-s {width}x{height} "
        f"-r {fps} "
        "-i - "
        "-c:v libx264 "
        "-preset fast "
        "-crf 18 "
        "-pix_fmt yuv420p "
        # shell-quote: the sink runs this via a shell, and the sidecar
        # publishes it for users to run — a path with quotes/$/backticks
        # must not split the command or execute
        f"{shlex.quote(out_path)}"
    )


_PIX_FMTS = {"rgba": (4, 1, "rgba"), "yuv420p": (3, 2, "yuv")}


def raw_extension(pix_fmt: str) -> str:
    """File extension for raw (ffmpeg-less fallback) dumps of `pix_fmt`."""
    return _PIX_FMTS[pix_fmt][2]


def _frame_bytes(width: int, height: int, pix_fmt: str) -> int:
    num, den, _ = _PIX_FMTS[pix_fmt]
    if den != 1 and (width % 2 or height % 2):
        # Reject at recorder CONSTRUCTION (both recorders route through
        # here), before any sink is opened or stale segments cleaned up —
        # otherwise the mismatch only surfaces as a mid-run trace error
        # from yuv420_from_rgba8 after destructive setup.
        raise ValueError(
            f"pix_fmt {pix_fmt!r} needs even dimensions, got "
            f"{width}x{height}"
        )
    return width * height * num // den


def timestamped_filename(prefix: str = "recording", ext: str = "mp4") -> str:
    """recording_YYYYmmdd_HHMMSS.mp4 (reference: main.cpp:36-50)."""
    now = datetime.datetime.now()
    return f"{prefix}_{now.strftime('%Y%m%d_%H%M%S')}.{ext}"


def default_record_dir() -> pathlib.Path:
    """Directory for AUTO-named recordings (explicit out_paths are used
    verbatim). `RRT_RECORDING_DIR` overrides; the default is the current
    directory, like the reference (main.cpp:36-50). Test/driver harnesses
    set the env var so stray R-toggles don't litter the source tree."""
    d = pathlib.Path(os.environ.get("RRT_RECORDING_DIR") or ".")
    d.mkdir(parents=True, exist_ok=True)
    return d


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


class SegmentedRecorder:
    """Checkpoint/resumable MP4 recording: frames are encoded into SEGMENT
    files (one finalized MP4 per `segment_frames` frames) that are
    losslessly concatenated (`ffmpeg -f concat -c copy`) on stop().

    This makes encoder state resumable — the analog of the reference's
    deterministic fixed-step clock (main.cpp:511-513) extended to the
    encoder: a killed job loses at most the open segment; finished segments
    plus the checkpoint JSON pin the exact next frame index. The raw-file
    path (VideoRecorder without ffmpeg) is natively appendable and does not
    need this.
    """

    def __init__(self, width: int, height: int, fps: int = RECORDING_FPS,
                 out_path: str = "animation.mp4", segment_frames: int = 24,
                 pix_fmt: str = "rgba"):
        if segment_frames <= 0:
            raise ValueError("segment_frames must be positive")
        if pix_fmt not in _PIX_FMTS:
            raise ValueError(f"unsupported pix_fmt {pix_fmt!r}")
        self.width = width
        self.height = height
        self.fps = fps
        self.pix_fmt = pix_fmt
        self.frame_bytes = _frame_bytes(width, height, pix_fmt)
        self.out_path = str(out_path)
        self.segment_frames = segment_frames
        self.seg_dir = pathlib.Path(self.out_path + ".segs")
        self._ckpt = pathlib.Path(self.out_path + ".ckpt.json")
        self._segments: list[dict] = []   # finalized: {start, frames, path}
        self._current: Optional[VideoRecorder] = None
        self._current_start = 0
        self._current_frames = 0
        self.next_frame = 0

    # --- resume bookkeeping ---
    def resume(self) -> int:
        """Load the checkpoint; returns the first frame index to render.
        Finished segments are kept; a crash's partial segment was never in
        the checkpoint, so its frames re-render. Geometry must match."""
        if not self._ckpt.exists():
            return 0
        state = json.loads(self._ckpt.read_text())
        if (state.get("width"), state.get("height"), state.get("fps"),
                state.get("pix_fmt", "rgba")) != (
            self.width, self.height, self.fps, self.pix_fmt
        ):
            raise ValueError(
                f"cannot resume {self.out_path}: checkpoint geometry "
                f"{state.get('width')}x{state.get('height')}@{state.get('fps')} "
                f"!= recorder {self.width}x{self.height}@{self.fps}"
            )
        segments = [
            s for s in state.get("segments", [])
            if pathlib.Path(s["path"]).exists()
        ]
        # segments must form a contiguous prefix 0..k — stop at the first gap
        good: list[dict] = []
        expect = 0
        for s in sorted(segments, key=lambda s: s["start"]):
            if s["start"] != expect:
                break
            good.append(s)
            expect = s["start"] + s["frames"]
        self._segments = good
        self.next_frame = expect
        return self.next_frame

    def truncate_to(self, n: int) -> int:
        """Drop resumed segments beyond frame count `n` (a re-run with a
        shorter --duration / lower --fps): whole segments past n are
        deleted; a segment straddling n is deleted too and its frames
        re-render (MP4 can't be trimmed losslessly). Returns the new
        next_frame (<= n)."""
        keep: list[dict] = []
        for s in self._segments:
            if s["start"] + s["frames"] <= n:
                keep.append(s)
                continue
            pathlib.Path(s["path"]).unlink(missing_ok=True)
        if len(keep) != len(self._segments):
            self._segments = keep
            self.next_frame = (
                keep[-1]["start"] + keep[-1]["frames"] if keep else 0
            )
            self._write_ckpt()
        return self.next_frame

    def _write_ckpt(self) -> None:
        self._ckpt.write_text(json.dumps({
            "width": self.width, "height": self.height, "fps": self.fps,
            "pix_fmt": self.pix_fmt,
            "next_frame": self.next_frame,
            "segments": self._segments,
        }))

    # --- recording ---
    def capture(self, frame: np.ndarray) -> None:
        if self._current is None:
            self.seg_dir.mkdir(exist_ok=True)
            seg_path = str(
                self.seg_dir / f"seg_{self.next_frame:08d}.mp4"
            )
            self._current = VideoRecorder(
                self.width, self.height, self.fps, out_path=seg_path,
                pix_fmt=self.pix_fmt,
            )
            self._current.start()
            self._current_start = self.next_frame
            self._current_frames = 0
        self._current.capture(frame)
        self._current_frames += 1
        self.next_frame += 1
        if self._current_frames >= self.segment_frames:
            self._finalize_segment()

    def _finalize_segment(self) -> None:
        if self._current is None:
            return
        rec, self._current = self._current, None
        path = rec.out_path
        rec.stop()
        self._segments.append({
            "start": self._current_start,
            "frames": self._current_frames,
            "path": path,
        })
        self._current_frames = 0
        self._write_ckpt()

    def abort(self) -> None:
        """Best-effort crash flush: finalize the open segment (its frames
        are complete and contiguous) and persist the checkpoint, but do NOT
        concat — a later resume() continues from here."""
        self._finalize_segment()

    def stop(self) -> int:
        """Finalize the open segment, concat everything into out_path,
        remove segments + checkpoint. Returns total frames in the video."""
        self._finalize_segment()
        total = sum(s["frames"] for s in self._segments)
        if not self._segments:
            return 0
        if len(self._segments) == 1:
            shutil.move(self._segments[0]["path"], self.out_path)
        else:
            def quote(path: pathlib.Path) -> str:
                # ffmpeg concat-list quoting: single quotes, inner quotes
                # escaped as '\'' (no shell is involved anywhere here)
                return "'" + str(path).replace("'", "'\\''") + "'"

            concat_list = self.seg_dir / "concat.txt"
            concat_list.write_text("".join(
                f"file {quote(pathlib.Path(s['path']).resolve())}\n"
                for s in self._segments
            ))
            import subprocess

            proc = subprocess.run(
                ["ffmpeg", "-y", "-f", "concat", "-safe", "0",
                 "-i", str(concat_list), "-c", "copy", self.out_path],
                capture_output=True,
            )
            if proc.returncode != 0:
                raise IOError(
                    f"ffmpeg concat failed ({proc.returncode}): "
                    f"{proc.stderr.decode(errors='replace')[-500:]}"
                )
        shutil.rmtree(self.seg_dir, ignore_errors=True)
        if self._ckpt.exists():
            self._ckpt.unlink()
        self._segments = []
        return total


class VideoRecorder:
    """Streaming recorder with the reference's start/capture/stop lifecycle
    (main.cpp:52-124), backed by the async native frame sink."""

    def __init__(self, width: int, height: int, fps: int = RECORDING_FPS,
                 out_path: Optional[str] = None, queue_frames: int = 8,
                 pix_fmt: str = "rgba"):
        if pix_fmt not in _PIX_FMTS:
            raise ValueError(f"unsupported pix_fmt {pix_fmt!r}")
        self.width = width
        self.height = height
        self.fps = fps
        self.pix_fmt = pix_fmt
        self.frame_bytes = _frame_bytes(width, height, pix_fmt)
        self._sink: Optional[FrameSink] = None
        self._user_out_path = out_path
        self.out_path = out_path
        self.raw_fallback = not ffmpeg_available()

    @property
    def is_recording(self) -> bool:
        return self._sink is not None

    def start(self, append_frames: int = 0) -> str:
        """Open the sink. append_frames > 0 (raw mode only) resumes an
        interrupted recording: the existing file is truncated to exactly
        that many whole frames and subsequent captures append."""
        if self._sink is not None:
            return self.out_path
        # Auto-named recordings get a FRESH timestamped file per start, like
        # the reference (main.cpp:36-57); an explicit out_path is reused.
        if self.raw_fallback:
            ext = _PIX_FMTS[self.pix_fmt][2]
            self.out_path = self._user_out_path or str(
                default_record_dir() / timestamped_filename(ext=ext)
            )
            if not self.out_path.endswith("." + ext):
                self.out_path = str(
                    pathlib.Path(self.out_path).with_suffix("." + ext)
                )
            append = append_frames > 0 and pathlib.Path(self.out_path).exists()
            if append:
                # The raw file is only resumable if it was written at this
                # exact geometry — check the sidecar before truncating. A
                # MISSING sidecar means the geometry is unknown (foreign or
                # tampered file): appending would truncate mid-frame of the
                # old geometry and interleave two resolutions, so refuse.
                side = pathlib.Path(self.out_path).with_suffix(".json")
                if not side.exists():
                    raise ValueError(
                        f"cannot resume {self.out_path}: its .json sidecar "
                        "is missing, so the frame geometry is unknown — "
                        "delete the file or start a fresh recording"
                    )
                prev = json.loads(side.read_text())
                if (prev.get("width"), prev.get("height"),
                        prev.get("fps"), prev.get("pix_fmt", "rgba")) != (
                    self.width, self.height, self.fps, self.pix_fmt
                ):
                    raise ValueError(
                        f"cannot resume {self.out_path}: it holds "
                        f"{prev.get('width')}x{prev.get('height')}"
                        f"@{prev.get('fps')} "
                        f"{prev.get('pix_fmt', 'rgba')} frames, recorder is "
                        f"{self.width}x{self.height}@{self.fps} "
                        f"{self.pix_fmt}"
                    )
                # Drop any partial frame a crash may have left behind.
                import os

                os.truncate(self.out_path, append_frames * self.frame_bytes)
            sidecar = {
                "format": f"rawvideo {self.pix_fmt}, top-down rows",
                "width": self.width,
                "height": self.height,
                "fps": self.fps,
                "pix_fmt": self.pix_fmt,
                # quote the INPUT path like ffmpeg_command quotes the
                # output one, and splice it at the single known "-i -"
                # stdin marker (a blanket str.replace would also corrupt
                # an output filename containing that substring)
                "encode_with": ffmpeg_command(
                    self.width, self.height, self.fps,
                    str(pathlib.Path(self.out_path).with_suffix(".mp4")),
                    pix_fmt=self.pix_fmt,
                ).replace(
                    "-i - ", f"-i {shlex.quote(self.out_path)} ", 1
                ),
            }
            pathlib.Path(self.out_path).with_suffix(".json").write_text(
                json.dumps(sidecar, indent=2)
            )
            self._sink = FrameSink(
                self.out_path, self.frame_bytes, mode="file", append=append
            )
        else:
            self.out_path = self._user_out_path or str(
                default_record_dir() / timestamped_filename()
            )
            cmd = ffmpeg_command(self.width, self.height, self.fps,
                                 self.out_path, pix_fmt=self.pix_fmt)
            self._sink = FrameSink(cmd, self.frame_bytes, mode="pipe")
        return self.out_path

    def capture(self, frame: np.ndarray) -> None:
        """frame: uint8 [height, width, 4] RGBA top-down rows — or, with
        pix_fmt="yuv420p", the flat planar uint8 buffer from
        render/postfx.yuv420_from_rgba8 (any shape, frame_bytes total)."""
        if self._sink is None:
            raise RuntimeError("recorder not started")
        if self.pix_fmt == "rgba":
            ok = (frame.shape == (self.height, self.width, 4)
                  and frame.dtype == np.uint8)
        else:
            ok = frame.dtype == np.uint8 and frame.size == self.frame_bytes
        if not ok:
            raise ValueError(
                f"bad {self.pix_fmt} frame {frame.shape} {frame.dtype}"
            )
        self._sink.submit(np.ascontiguousarray(frame).tobytes())

    def stop(self) -> int:
        """Finalize; returns the number of frames written. The recorder is
        always reusable afterwards, even if the sink reports a write error
        (close() raising must not wedge is_recording)."""
        if self._sink is None:
            return 0
        try:
            return self._sink.close()
        finally:
            self._sink = None

    def toggle(self) -> bool:
        """R-key semantics (main.cpp:113-119). Returns new recording state."""
        if self.is_recording:
            self.stop()
            return False
        self.start()
        return True

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
