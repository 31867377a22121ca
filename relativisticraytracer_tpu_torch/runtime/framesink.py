"""ctypes bindings for the native frame sink (native/framesink.cpp), with a
pure-Python fallback (port of relativisticraytracer_tpu.runtime.framesink;
the same library, built by native/Makefile into native/build/).

The native library decouples frame production (the render loop) from
frame consumption (FFmpeg encode / raw file write) via a ring buffer and a
writer thread — the reference stalls its render loop on a synchronous
fwrite into the FFmpeg pipe (src/main.cpp:85-97); we do not.
"""

from __future__ import annotations

import ctypes
import pathlib
import queue
import subprocess
import threading
from typing import Optional

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "build" / "libframesink.so"

_lib = None
_lib_tried = False


def _load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    ABI = 2

    def build():
        subprocess.run(
            ["make", "-s"], cwd=_NATIVE_DIR, check=True,
            capture_output=True, timeout=120,
        )

    try:
        if not _LIB_PATH.exists():
            build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        # A stale pre-ABI library would misinterpret the append mode and
        # truncate files being resumed — rebuild on any version mismatch.
        try:
            lib.fs_abi_version.restype = ctypes.c_long
            ok = lib.fs_abi_version() == ABI
        except AttributeError:
            ok = False
        if not ok:
            subprocess.run(["make", "clean"], cwd=_NATIVE_DIR,
                           capture_output=True, timeout=60)
            build()
            lib = ctypes.CDLL(str(_LIB_PATH))
            lib.fs_abi_version.restype = ctypes.c_long
            if lib.fs_abi_version() != ABI:
                raise RuntimeError("framesink ABI mismatch after rebuild")
        lib.fs_create.restype = ctypes.c_void_p
        lib.fs_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_long, ctypes.c_int,
        ]
        lib.fs_submit.restype = ctypes.c_int
        lib.fs_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long,
        ]
        lib.fs_frames_written.restype = ctypes.c_long
        lib.fs_frames_written.argtypes = [ctypes.c_void_p]
        lib.fs_has_error.restype = ctypes.c_int
        lib.fs_has_error.argtypes = [ctypes.c_void_p]
        lib.fs_close.restype = ctypes.c_long
        lib.fs_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


class FrameSink:
    """Asynchronous frame consumer.

    target: shell command (mode='pipe') or file path (mode='file').
    Frames are fixed-size bytes; submit() copies and returns immediately
    unless `queue_frames` are already in flight.
    """

    def __init__(self, target: str, frame_bytes: int, mode: str = "file",
                 queue_frames: int = 8, force_python: bool = False,
                 append: bool = False):
        if mode not in ("pipe", "file"):
            raise ValueError(f"bad mode {mode!r}")
        if append and mode != "file":
            raise ValueError("append only valid for file sinks")
        self.frame_bytes = frame_bytes
        self._handle = None
        self._py = None
        lib = None if force_python else _load_library()
        if lib is not None:
            native_mode = 0 if mode == "pipe" else (2 if append else 1)
            handle = lib.fs_create(
                target.encode(), native_mode, frame_bytes, queue_frames,
            )
            if handle:
                self._handle = ctypes.c_void_p(handle)
                self._lib = lib
                return
        self._py = _PythonSink(target, mode, queue_frames, append)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def submit(self, frame: bytes) -> None:
        if len(frame) != self.frame_bytes:
            raise ValueError(
                f"frame is {len(frame)} bytes, expected {self.frame_bytes}"
            )
        if self._handle is not None:
            rc = self._lib.fs_submit(self._handle, frame, len(frame))
            if rc != 0:
                raise IOError("frame sink write failed")
        else:
            self._py.submit(frame)

    def frames_written(self) -> int:
        if self._handle is not None:
            return int(self._lib.fs_frames_written(self._handle))
        return self._py.frames_written

    def close(self) -> int:
        if self._handle is not None:
            # fs_close drains the remaining queued frames and returns -1 if
            # ANY write failed, including during that final drain.
            n = int(self._lib.fs_close(self._handle))
            self._handle = None
            if n < 0:
                raise IOError("frame sink write failed; output is incomplete")
            return n
        if self._py is not None:
            return self._py.close()
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _PythonSink:
    """Fallback: same ring-buffer/writer-thread design in Python."""

    def __init__(self, target: str, mode: str, queue_frames: int,
                 append: bool = False):
        self.frames_written = 0
        self.error = False
        self._proc = None
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue(maxsize=queue_frames)
        if mode == "pipe":
            self._proc = subprocess.Popen(
                target, shell=True, stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
            self._out = self._proc.stdin
        else:
            self._out = open(target, "ab" if append else "wb")
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            frame = self._q.get()
            if frame is None:
                return
            if self.error:
                continue  # keep draining so producers never deadlock
            try:
                self._out.write(frame)
                self.frames_written += 1
            except Exception:
                self.error = True  # e.g. BrokenPipeError: encoder died

    def submit(self, frame: bytes) -> None:
        if self.error:
            raise IOError("frame sink write failed (consumer error)")
        self._q.put(frame)

    def close(self) -> int:
        self._q.put(None)
        self._thread.join()
        try:
            self._out.close()
        except Exception:
            self.error = True
        if self._proc is not None:
            self._proc.wait()
        if self.error:
            raise IOError("frame sink failed; output is incomplete")
        return self.frames_written
