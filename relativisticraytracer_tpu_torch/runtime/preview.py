"""Live interactive preview: MJPEG over HTTP (stdlib http.server + Pillow)
(port of relativisticraytracer_tpu.runtime.preview).

The server-side analog of the reference's GLFW window + fly camera
(src/main.cpp:482-539): a background thread runs `Session.tick` (the same
main-loop semantics — fixed-step clock while recording, path playback,
effect toggles) and streams JPEG frames to any browser via
multipart/x-mixed-replace; key and mouse events post back into
`Session.handle_key` / `Session.mouse` (key_callback main.cpp:270-306,
mouse_callback main.cpp:308-327). No GL, no window system — the display
pipeline is an HTTP socket.

    python -m relativisticraytracer_tpu_torch interactive --port 8000
    # open http://localhost:8000 — click the view to capture the mouse;
    # WASD/Space/Shift fly, R records, P plays a path, N next path,
    # B/V/L/C toggle effects.

The JPEG encoder is Pillow's, imported when the server starts: without
Pillow, `PreviewServer.start` raises ImportError and the terminal preview
(`run_terminal_preview`, no Pillow) still runs.
"""

from __future__ import annotations

import io
import threading
import time as _time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from relativisticraytracer_tpu_torch.runtime.app import Session

_PAGE = """<!DOCTYPE html>
<html><head><title>Relativistic Ray Tracer (GPU)</title><style>
  body { margin:0; background:#000; color:#9a9; font:13px monospace;
         display:flex; flex-direction:column; align-items:center }
  #v { margin-top:8px; cursor:crosshair; image-rendering:auto }
  #s { padding:6px }
</style></head><body>
<img id="v" src="/stream">
<div id="s">connecting…</div>
<script>
const v = document.getElementById('v');
const post = (path) => fetch(path, {method:'POST'});
v.addEventListener('click', () => v.requestPointerLock());
document.addEventListener('mousemove', (e) => {
  if (document.pointerLockElement === v && (e.movementX || e.movementY))
    post(`/mouse?dx=${e.movementX}&dy=${e.movementY}`);
});
const KEYS = {'w':'w','a':'a','s':'s','d':'d',' ':'space','Shift':'shift',
              'r':'r','p':'p','n':'n','b':'b','v':'v','l':'l','c':'c',
              'Escape':'escape'};
document.addEventListener('keydown', (e) => {
  const k = KEYS[e.key] ?? KEYS[e.key.toLowerCase()];
  if (k) { post(`/key?k=${k}`); e.preventDefault(); }
});
setInterval(async () => {
  const r = await fetch('/status');
  document.getElementById('s').textContent = await r.text();
}, 1000);
</script></body></html>"""


class PreviewServer:
    """Serve a live `Session` over HTTP.

    GET  /           the control page
    GET  /stream     multipart/x-mixed-replace MJPEG stream
    GET  /frame.jpg  one JPEG frame
    GET  /status     the reference's title-bar line (Session.status)
    POST /key?k=X    key press (R/P/N/B/V/L/C, movement keys)
    POST /mouse?dx&dy  relative mouse look
    """

    def __init__(self, session: Session, host: str = "127.0.0.1",
                 port: int = 8000, fps_cap: float = 30.0,
                 jpeg_quality: int = 85):
        self.session = session
        self.fps_cap = fps_cap
        self.jpeg_quality = jpeg_quality
        self._frame_jpeg: Optional[bytes] = None
        self._frame_seq = 0
        self._error: Optional[str] = None
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._render_thread: Optional[threading.Thread] = None

        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/":
                    self._send(200, "text/html; charset=utf-8",
                               _PAGE.encode())
                elif path == "/status":
                    if server._error is not None:
                        self._send(500, "text/plain; charset=utf-8",
                                   f"render loop died: {server._error}".encode())
                    else:
                        self._send(200, "text/plain; charset=utf-8",
                                   server.session.status().encode())
                elif path == "/frame.jpg":
                    frame = server.wait_frame(None)
                    if frame is None:
                        self._send(503, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/jpeg", frame)
                elif path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    seq = -1
                    try:
                        while not server._stop.is_set():
                            frame, seq = server.wait_frame(seq)
                            if frame is None:
                                continue
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/jpeg\r\n"
                                + f"Content-Length: {len(frame)}\r\n\r\n".encode()
                            )
                            self.wfile.write(frame)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # viewer went away
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                u = urlparse(self.path)
                q = parse_qs(u.query)
                if u.path == "/key" and "k" in q:
                    server.session.handle_key(q["k"][0])
                    self._send(200, "application/json", b"{}")
                elif u.path == "/mouse":
                    dx = float(q.get("dx", ["0"])[0])
                    dy = float(q.get("dy", ["0"])[0])
                    server.session.mouse(dx, dy)
                    self._send(200, "application/json", b"{}")
                else:
                    self._send(404, "text/plain", b"not found")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    # --- frame exchange ---
    def _publish(self, jpeg: bytes) -> None:
        with self._cond:
            self._frame_jpeg = jpeg
            self._frame_seq += 1
            self._cond.notify_all()

    def wait_frame(self, last_seq: Optional[int], timeout: float = 90.0):
        """Block until a frame newer than last_seq exists (last_seq=None:
        any frame). Returns (jpeg, seq) — or just jpeg when last_seq is
        None."""
        with self._cond:
            if last_seq is None:
                # first frame can take a full kernel compile — wait it out
                self._cond.wait_for(
                    lambda: self._frame_jpeg is not None
                    or self._stop.is_set(),
                    timeout,
                )
                return self._frame_jpeg
            self._cond.wait_for(
                lambda: self._frame_seq != last_seq or self._stop.is_set(),
                timeout,
            )
            return self._frame_jpeg, self._frame_seq

    def _render_loop(self) -> None:
        import logging

        from PIL import Image

        last = _time.perf_counter()
        while not self._stop.is_set():
            now = _time.perf_counter()
            dt, last = now - last, now
            if getattr(self.session, "quit_requested", False):
                # ESC (main.cpp:303-305): end the loop; serve_until_interrupt
                # (or the owner) runs the full stop()/close() teardown.
                self._stop.set()
                with self._cond:
                    self._cond.notify_all()
                return
            try:
                frame = self.session.tick(dt)
                buf = io.BytesIO()
                Image.fromarray(frame[..., :3]).save(
                    buf, "JPEG", quality=self.jpeg_quality
                )
            except Exception as e:  # surface instead of freezing the viewer
                logging.getLogger("relativisticraytracer_tpu_torch").exception(
                    "preview render loop died"
                )
                self._error = repr(e)
                self._stop.set()
                with self._cond:
                    self._cond.notify_all()
                return
            self._publish(buf.getvalue())
            # fps cap (don't melt the card for an idle viewer)
            budget = 1.0 / self.fps_cap - (_time.perf_counter() - now)
            if budget > 0:
                self._stop.wait(budget)

    # --- lifecycle ---
    def start(self) -> None:
        try:
            import PIL.Image  # noqa: F401
        except ImportError as e:
            self.httpd.server_close()
            raise ImportError(
                "PreviewServer encodes JPEG with Pillow, which is not installed; "
                "use the terminal preview (interactive --terminal) instead"
            ) from e
        self._render_thread = threading.Thread(
            target=self._render_loop, daemon=True
        )
        self._render_thread.start()
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._render_thread is not None:
            self._render_thread.join(timeout=10)
        self.session.close()

    def serve_until_interrupt(self) -> None:
        self.start()
        try:
            # wake on ESC-driven shutdown (session.quit_requested) too
            while not self._stop.wait(timeout=1.0):
                pass
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()


def run_terminal_preview(session: Session, frames: int = 0,
                         width: int = 100, fps_cap: float = 15.0,
                         out=None) -> None:
    """Minimal no-browser preview: ANSI half-block rendering in a terminal.
    `frames=0` runs until Ctrl-C. Downsamples the session frame to
    `width` columns (two pixel rows per character row via '▀')."""
    import sys

    import numpy as np

    out = out or sys.stdout
    k = 0
    last = _time.perf_counter()
    try:
        while frames == 0 or k < frames:
            if session.quit_requested:  # ESC, main.cpp:303-305
                break
            now = _time.perf_counter()
            dt, last = now - last, now
            frame = session.tick(dt)[..., :3].astype(np.int32)
            h, w = frame.shape[:2]
            step = max(1, w // width)
            small = frame[:: 2 * step, ::step]
            lower = frame[step :: 2 * step, ::step]
            rows = min(len(small), len(lower))
            lines = []
            for y in range(rows):
                line = []
                for x in range(small.shape[1]):
                    tr, tg, tb = small[y, x]
                    br, bg_, bb = lower[y, x]
                    line.append(
                        f"\x1b[38;2;{tr};{tg};{tb}m"
                        f"\x1b[48;2;{br};{bg_};{bb}m▀"
                    )
                lines.append("".join(line) + "\x1b[0m")
            out.write("\x1b[H\x1b[2J" if k == 0 else "\x1b[H")
            out.write("\n".join(lines))
            out.write(f"\n{session.status()}\n")
            out.flush()
            k += 1
            budget = 1.0 / fps_cap - (_time.perf_counter() - now)
            if budget > 0:
                _time.sleep(budget)
    except KeyboardInterrupt:
        pass
