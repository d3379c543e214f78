"""Live interactive viewer (`tpu_fluid.render.live`): in-process HTTP
MJPEG stream + key controls.

The reference is an interactive GLFW window: a fly camera plus key toggles
(`main.cpp:152-166` — Q pause, E resume, R surface off, F surface on; WASD
camera movement via `Camera::update`).  A GPU host is often headless,
so the equivalent is a tiny stdlib HTTP server running next to the
simulation loop:

  /         a minimal HTML page: the stream plus a key-capture script
  /stream   multipart/x-mixed-replace MJPEG of the latest rendered frame
  /key?k=X  applies a key to the live Simulation (same bindings as the
            reference: q/e pause/resume, r/f surface off/on, plus a/d
            orbit, w/s dolly, p particle toggle, arrow keys strafe,
            space/shift fly up/down — the reference's full WASD +
            space/shift camera, `main.cpp:128,160`, `README.md:14-18`)
  /state    JSON of the current toggles (also used by tests)

Start with `tpu-fluid-torch ... --serve 8089 --frame-every N` and open
http://localhost:8089/ — the sim keeps rendering while paused, exactly like
the reference's pause (`main.cpp:163-177`).

The server binds 127.0.0.1 by default: /key mutates live state and /stream
exposes frames, so network exposure is opt-in (`--serve-host 0.0.0.0`).
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from tpu_fluid_torch.render.export import to_host

_PAGE = b"""<!doctype html><title>tpu-fluid live</title>
<style>body{background:#111;color:#ddd;font:14px monospace;text-align:center}
img{max-width:96vw;max-height:86vh;image-rendering:pixelated}</style>
<body><h3>tpu-fluid &mdash; q pause &middot; e resume &middot; r/f surface
off/on &middot; p particles &middot; a/d orbit &middot; w/s dolly &middot;
&larr;/&rarr; strafe &middot; space/shift up/down</h3>
<img src="/stream"><script>
document.addEventListener('keydown', ev => {
  if (ev.key === ' ' || ev.key.startsWith('Arrow')) ev.preventDefault();
  fetch('/key?k=' + encodeURIComponent(ev.key));
});
</script></body>"""


class LiveViewer:
    """Serves the latest rendered frame and routes keys to a Simulation."""

    def __init__(self, sim, port: int = 8089, quality: int = 85,
                 host: str = "127.0.0.1"):
        self.sim = sim
        self.port = port
        self.host = host
        self.quality = quality
        self._jpeg = None
        self._seq = 0
        self._cond = threading.Condition()
        self._server = None
        self._thread = None

    # ------------------------------------------------------------- frames
    def push(self, img) -> None:
        """Encode (H, W, 3) uint8 -> JPEG and publish it to all streams
        (needs PIL)."""
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray(to_host(img)).save(buf, format="JPEG",
                                           quality=self.quality)
        with self._cond:
            self._jpeg = buf.getvalue()
            self._seq += 1
            self._cond.notify_all()

    def wait_frame(self, last_seq: int, timeout: float = 5.0):
        with self._cond:
            self._cond.wait_for(lambda: self._seq != last_seq, timeout)
            return self._jpeg, self._seq

    # --------------------------------------------------------------- keys
    def apply_key(self, k: str) -> None:
        sim = self.sim
        center = tuple(g / 2.0 for g in sim.cfg.grid_size)
        if k == "q":
            sim.pause()
        elif k == "e":
            sim.resume()
        elif k == "r":
            sim.render_surface = False
        elif k == "f":
            sim.render_surface = True
        elif k == "p":
            sim.render_particles = not sim.render_particles
        elif k == "a":
            sim.camera = sim.camera.orbit(-6.0, center)
        elif k == "d":
            sim.camera = sim.camera.orbit(6.0, center)
        elif k in ("w", "s"):
            import numpy as np
            pos = np.asarray(sim.camera.position, dtype=np.float64)
            to_c = np.asarray(center, dtype=np.float64) - pos
            step = to_c / max(np.linalg.norm(to_c), 1e-6) \
                * (2.0 if k == "w" else -2.0)
            sim.camera = sim.camera.move(tuple(step))
        elif k in ("ArrowLeft", "ArrowRight"):
            # lateral translation (the reference's A/D strafe,
            # `main.cpp:128,160`): move along the camera's right vector
            # without re-aiming
            import numpy as np
            d = np.asarray(sim.camera.direction, dtype=np.float64)
            up = np.asarray(sim.camera.up, dtype=np.float64)
            right = np.cross(d / max(np.linalg.norm(d), 1e-6), up)
            right = right / max(np.linalg.norm(right), 1e-6)
            step = right * (-2.0 if k == "ArrowLeft" else 2.0)
            sim.camera = sim.camera.move(tuple(step))
        elif k in (" ", "Shift"):
            # vertical translation (the reference's space/shift fly keys,
            # `README.md:14-18`): the scene's up is -y (`main.cpp:128`)
            import numpy as np
            up = np.asarray(sim.camera.up, dtype=np.float64)
            up = up / max(np.linalg.norm(up), 1e-6)
            step = up * (2.0 if k == " " else -2.0)
            sim.camera = sim.camera.move(tuple(step))

    def state(self) -> dict:
        return {"paused": self.sim.paused,
                "surface": self.sim.render_surface,
                "particles": self.sim.render_particles,
                "frames": self._seq}

    # ------------------------------------------------------------- server
    def start(self) -> "LiveViewer":
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # silence per-request stderr
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE)
                elif u.path == "/state":
                    body = json.dumps(viewer.state()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                elif u.path == "/key":
                    k = parse_qs(u.query).get("k", [""])[0]
                    viewer.apply_key(k)
                    self.send_response(204)
                    self.end_headers()
                elif u.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    seq = -1
                    try:
                        while True:
                            jpeg, seq = viewer.wait_frame(seq)
                            if jpeg is None:
                                continue
                            self.wfile.write(b"--frame\r\n"
                                             b"Content-Type: image/jpeg\r\n"
                                             b"\r\n" + jpeg + b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]   # resolve port 0
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
