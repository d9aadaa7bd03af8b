"""Live progressive viewer: the reference's window, served over HTTP.

The reference opens a tao window with a `pixels` GPU surface and repaints
the accumulating buffer on every redraw (renderer/src/main.rs:34-194). A
GPU render box is headless, so the real-time display path here is a tiny
threaded HTTP server: `/` is a page with an auto-refreshing image, and
`/stream` is a multipart/x-mixed-replace PNG stream — every call to
`LiveViewer.update(pixels)` pushes the freshly accumulated frame to all
connected browsers, giving the same continuous progressive-refinement
experience (main.rs:108-110's request_redraw loop) over the network.

Interactive controls close the loop the reference's window left stubbed
(main.rs:133-190 carries the mouse/keyboard event plumbing; Camera3D::set
exists for runtime camera moves, pinhole.rs:27-30): the page POSTs
drag/wheel/key events to /control as JSON ({"orbit": [dx, dy]},
{"zoom": factor}, {"fov": delta_deg}, {"reset": true}); the render loop
drains them with `pop_controls()` once per frame, moves the camera
(models.camera.orbit / zoom), and restarts accumulation.

PNG encoding rides the native C runtime's threaded tonemap+encode when
built (utils/native.tonemap_encode_png), falling back to the pure-Python
encoder (utils/image.encode_png). Stdlib-only; no extra dependencies.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = b"""<!doctype html>
<html><head><title>pathtracer_tpu live render</title>
<style>body{background:#111;margin:0;display:grid;place-items:center;
height:100vh}img{image-rendering:pixelated;max-width:96vw;max-height:96vh;
cursor:grab;user-select:none}</style></head>
<body><img id="v" src="/stream" alt="progressive render" draggable="false">
<script>
const img = document.getElementById("v");
let drag = false, lx = 0, ly = 0;
const post = (msg) => fetch("/control", {
  method: "POST", body: JSON.stringify(msg)});
img.addEventListener("mousedown", (e) => {
  drag = true; lx = e.clientX; ly = e.clientY; e.preventDefault();});
window.addEventListener("mouseup", () => { drag = false; });
window.addEventListener("mousemove", (e) => {
  if (!drag) return;
  const dx = e.clientX - lx, dy = e.clientY - ly;
  lx = e.clientX; ly = e.clientY;
  if (dx || dy) post({orbit: [dx, dy]});});
img.addEventListener("wheel", (e) => {
  e.preventDefault(); post({zoom: Math.exp(e.deltaY * 0.001)});},
  {passive: false});
window.addEventListener("keydown", (e) => {
  if (e.key === "r") post({reset: true});
  if (e.key === "+" || e.key === "=") post({fov: -5});
  if (e.key === "-") post({fov: 5});});
</script></body></html>
"""


def _encode(pixels) -> bytes:
    arr = np.asarray(pixels, np.float32)
    try:
        from .native import tonemap_encode_png

        return tonemap_encode_png(arr, gamma=True)
    except Exception:
        from .buffer import to_u8
        from .image import encode_png

        return encode_png(np.asarray(to_u8(arr)))


class LiveViewer:
    """Threaded progressive-render viewer; call update() once per frame."""

    def __init__(self, port: int = 8000, host: str = "0.0.0.0"):
        self._lock = threading.Condition()
        self._png: bytes | None = None
        self._seq = 0
        self._closed = False
        self._controls: list = []
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def do_POST(self):
                if self.path != "/control":
                    self.send_response(404)
                    self.end_headers()
                    return
                import json

                n = int(self.headers.get("Content-Length", 0) or 0)
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    assert isinstance(msg, dict)
                except Exception:
                    self.send_response(400)
                    self.end_headers()
                    return
                with viewer._lock:
                    viewer._controls.append(msg)
                self.send_response(204)
                self.end_headers()

            def do_GET(self):
                if self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    seen = -1
                    try:
                        while not viewer._closed:
                            with viewer._lock:
                                viewer._lock.wait_for(
                                    lambda: viewer._closed
                                    or viewer._seq != seen,
                                    timeout=5.0,
                                )
                                png, seen = viewer._png, viewer._seq
                            if png is None:
                                continue
                            self.wfile.write(b"--frame\r\n")
                            self.wfile.write(b"Content-Type: image/png\r\n")
                            self.wfile.write(
                                f"Content-Length: {len(png)}\r\n\r\n".encode()
                            )
                            self.wfile.write(png)
                            self.wfile.write(b"\r\n")
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                elif self.path == "/frame.png":
                    with viewer._lock:
                        png = viewer._png
                    if png is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.end_headers()
                    self.wfile.write(png)
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(_PAGE)))
                    self.end_headers()
                    self.wfile.write(_PAGE)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def update(self, pixels) -> None:
        """Publish the latest accumulated [H, W, 4] linear buffer."""
        png = _encode(pixels)
        with self._lock:
            self._png = png
            self._seq += 1
            self._lock.notify_all()

    def pop_controls(self) -> list:
        """Drain pending /control messages (camera events from the served
        page), oldest first. Call once per frame from the render loop."""
        with self._lock:
            msgs, self._controls = self._controls, []
        return msgs

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._server.shutdown()
        self._server.server_close()


__all__ = ["LiveViewer"]
