"""Background map/trajectory viewer writing periodic snapshots, and a live
viewer over HTTP (port of ``rumi_slam_tpu/evaluation/viewer.py``; it holds
no array code of its own: ``plot`` renders).

Headless equivalent of the reference's Pangolin viewer thread
(Viewer.cc Viewer::Run, spawned by System.cc:236-244): a daemon thread that
renders the current MapState (per-submap colored points + KF trajectory +
covisibility graph) to PNGs at a fixed cadence.  Rendering consumes
snapshots (every map update returns new tensors), so it never blocks or
races the tracker.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Optional


class MapViewer:
    """Daemon snapshotter: ``viewer = MapViewer(slam, out_dir); viewer.start()``.

    Writes ``map_<k>.png`` (+ optional ``frame_<k>.png`` when the system has
    a frame recorder attached) every ``period_s`` seconds until ``stop()``.
    """

    def __init__(self, slam, out_dir, *, period_s: float = 2.0,
                 draw_covisibility: bool = False):
        self.slam = slam
        self.out_dir = Path(out_dir)
        self.period_s = period_s
        self.draw_covisibility = draw_covisibility
        self.n_snapshots = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self, *, final_snapshot: bool = True):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        if final_snapshot:
            self._snapshot()

    def _snapshot(self):
        from . import plot

        ms = self.slam.ms  # immutable snapshot — no locking needed
        if int(ms.n_kf) < 1:
            return
        k = self.n_snapshots
        try:
            plot.plot_map(self.out_dir / f"map_{k:04d}.png", ms,
                          title=f"map @ {int(ms.n_kf)} KFs")
            if self.draw_covisibility:
                plot.plot_covisibility(
                    self.out_dir / f"covis_{k:04d}.png", ms)
            self.n_snapshots += 1
        except Exception:
            pass  # rendering must never take down tracking

    def _run(self):
        while not self._stop.wait(self.period_s):
            self._snapshot()


class LiveViewer:
    """Live map viewer over HTTP — the headless deployment's stand-in for
    the reference's Pangolin window (Viewer.cc Viewer::Run): serves an
    auto-refreshing page with the current map render plus a live stats
    JSON, reading immutable MapState snapshots so it never blocks or races
    the tracker.

    ``LiveViewer(slam, port=8642).start()`` then open http://host:8642/;
    ``port=0`` binds a free port, which ``start()`` writes back to ``port``.
    Endpoints: ``/`` (html), ``/map.png`` (fresh render), ``/stats``.
    """

    def __init__(self, slam, *, port: int = 8642, period_s: float = 1.0,
                 host: str = "127.0.0.1"):
        self.slam = slam
        self.port = port
        self.host = host            # loopback by default: the map/stats are
        self.period_s = period_s    # not meant for the whole network
        self._httpd = None
        self._thread: Optional[threading.Thread] = None
        self._render_lock = threading.Lock()

    def start(self):
        import http.server
        import io
        import json

        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    if self.path == "/stats":
                        slam = viewer.slam
                        ms = slam.ms
                        body = json.dumps({
                            **slam.stats,
                            "state": slam.state.name,
                            "n_maps": int(ms.n_maps),
                            "active_map": int(ms.active_map),
                        }).encode()
                        self._send(200, "application/json", body)
                    elif self.path == "/map.png":
                        from . import plot

                        ms = viewer.slam.ms
                        buf = io.BytesIO()
                        # pyplot keeps global figure state: concurrent
                        # handler threads must not interleave renders
                        with viewer._render_lock:
                            plot.plot_map(buf, ms,
                                          title=f"live @ {int(ms.n_kf)} KFs")
                        self._send(200, "image/png", buf.getvalue())
                    else:
                        t = int(viewer.period_s * 1000)
                        html = (
                            "<html><head><title>rumi_slam_tpu_torch live</title>"
                            "</head><body style='background:#111;"
                            "color:#eee;font-family:monospace'>"
                            "<pre id=s></pre>"
                            "<img id=m src=/map.png style='max-width:100%'>"
                            f"<script>setInterval(async()=>{{"
                            "document.getElementById('s').textContent="
                            "JSON.stringify(await (await fetch('/stats'))"
                            ".json(),null,1);"
                            "document.getElementById('m').src="
                            f"'/map.png?'+Date.now()}},{t});</script>"
                            "</body></html>").encode()
                        self._send(200, "text/html", html)
                except BrokenPipeError:
                    pass
                except Exception:
                    try:
                        self._send(500, "text/plain", b"render error")
                    except Exception:
                        pass

        import http.server as hs
        import socketserver

        class Server(socketserver.ThreadingMixIn, hs.HTTPServer):
            daemon_threads = True

        self._httpd = Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
