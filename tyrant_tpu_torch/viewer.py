"""Interactive host viewers, the port of ``tyrant_tpu/viewer.py``.

* :class:`HttpViewer`: a dependency-free web viewer on 127.0.0.1 that
  streams PNG frames to the page and feeds WASD/mouse/slider input back
  into the fly camera, the lens and the sun, with a frame-time readout
  and histogram.
* :class:`TerminalViewer`: an ANSI half-block preview for ssh sessions.

PNG frames are encoded here with ``zlib`` and ``struct`` (8-bit RGB,
filter 0 on each row, one IDAT chunk): no imaging package is needed.

Run: ``python -m tyrant_tpu_torch.viewer --scene scene.ply`` (on the GPU;
``--device cpu`` for the CPU), then open the printed URL.
"""

from __future__ import annotations

import json
import struct
import threading
import time
import zlib

import numpy as np
import torch

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_FRAME_PNG_LEVEL = 1  # the viewer's frames: fast over small


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _to_png_bytes(img_u8: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit RGB PNG of ``img_u8`` [H, W, 3]: each row with filter 0,
    all in one IDAT chunk compressed at zlib ``level``."""
    img = np.ascontiguousarray(img_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"an RGB image [H, W, 3] is needed, got {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                         axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_PNG_MAGIC + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _png_chunk(b"IEND", b""))


_PAGE = """<!doctype html><html><head><title>tyrant_tpu_torch</title><style>
body{margin:0;background:#111;color:#ccc;font:13px monospace;display:flex}
#v{flex:1;display:flex;align-items:center;justify-content:center}
img{max-width:100%%;image-rendering:pixelated}
#hud{width:230px;padding:10px;background:#1a1a1a}
label{display:block;margin-top:8px}
input[type=range]{width:100%%}
</style></head><body>
<div id=v><img id=f></div>
<div id=hud>
 <div id=stats>-</div>
 <canvas id=hist width=210 height=48 style="background:#000;margin-top:6px"></canvas>
 <label>focal distance <input type=range id=fd min=0.1 max=60 step=0.1 value=1></label>
 <label>lens radius <input type=range id=lr min=0 max=1 step=0.01 value=0></label>
 <label>sun azimuth <input type=range id=sx min=0 max=1 step=0.005 value=0.05></label>
 <label>sun height <input type=range id=sy min=0 max=1 step=0.005 value=0.3></label>
 <p>WASD move &middot; drag to look<br>shift = sprint &middot; space/ctrl = up/down</p>
</div>
<script>
const img=document.getElementById('f');const keys={};let drag=null;
onkeydown=e=>keys[e.key.toLowerCase()]=1;onkeyup=e=>keys[e.key.toLowerCase()]=0;
img.onmousedown=e=>{drag=[e.clientX,e.clientY]};
onmouseup=()=>drag=null;
onmousemove=e=>{if(drag){post({look:[e.clientX-drag[0],e.clientY-drag[1]]});drag=[e.clientX,e.clientY]}};
function post(o){fetch('/input',{method:'POST',body:JSON.stringify(o)})}
setInterval(()=>{
 const f=(keys['w']?1:0)-(keys['s']?1:0), s=(keys['d']?1:0)-(keys['a']?1:0),
       v=(keys[' ']?1:0)-(keys['control']?1:0);
 if(f||s||v)post({move:[f,s,v],sprint:keys['shift']?1:0});
},50);
for(const id of['fd','lr','sx','sy'])
 document.getElementById(id).oninput=e=>post({[id]:parseFloat(e.target.value)});
const hist=document.getElementById('hist'),hctx=hist.getContext('2d');
function drawHist(ts){
 hctx.clearRect(0,0,210,48);if(!ts.length)return;
 const mx=Math.max(...ts,1e-6),w=210/Math.max(ts.length,1);
 hctx.fillStyle='#6c6';
 ts.forEach((t,i)=>{const h=44*t/mx;hctx.fillRect(i*w,48-h,Math.max(w-1,1),h)});
 hctx.fillStyle='#888';hctx.font='9px monospace';
 hctx.fillText(mx.toFixed(0)+' ms',2,9)}
async function loop(){
 img.src='/frame.png?'+Date.now();
 const r=await fetch('/stats');const s=await r.json();
 document.getElementById('stats').innerText=s.text;drawHist(s.times);
 setTimeout(loop,100)}
loop();
</script></body></html>"""


class _Fetch:
    """One frame's display image on its way to the host: a copy into a
    pinned buffer, issued without waiting, and the CUDA event after it.
    On the CPU the copy is made at once."""

    def __init__(self, img: torch.Tensor, host: torch.Tensor | None):
        if img.device.type != "cuda":
            self.host, self.event = img.clone(), None
            return
        self.host = host
        self.host.copy_(img, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(img.device))

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class HttpViewer:
    def __init__(self, renderer, camera, port: int = 8760,
                 steps_per_frame: int = 1, preview_scale: int = 1):
        """``preview_scale``: fetch the framebuffer downsampled by this
        factor (a strided slice on the device; the accumulation stays at
        full resolution).  ``port`` 0 takes a free one (read ``port``
        after :meth:`start`)."""
        self.renderer = renderer
        self.camera = camera
        self.port = port
        self.steps_per_frame = steps_per_frame
        self.preview_scale = max(1, int(preview_scale))
        self.frames = 0  # frames whose PNG has been published
        self._png = b""
        self._stats = "starting"
        self._times: list[float] = []
        self._inputs: list[dict] = []
        self._lock = threading.Lock()
        self._running = False
        self._threads: list[threading.Thread] = []
        self._srv = None
        self._error: BaseException | None = None

    def _apply_inputs(self):
        """The requests queued by the HTTP handler, applied between frames
        on the render thread (the renderer is driven from one thread)."""
        with self._lock:
            msgs, self._inputs = self._inputs, []
        cam = self.camera
        for msg in msgs:
            if "move" in msg:
                f, s, v = msg["move"]
                cam.move(forward=f, strafe=s, vertical=v, delta=0.05,
                         sprint=bool(msg.get("sprint")))
            if "look" in msg:
                dx, dy = msg["look"]
                cam.look(dx, dy)
            if "fd" in msg:
                cam.focal_distance = float(msg["fd"])
            if "lr" in msg:
                cam.lens_radius = float(msg["lr"])
            if "sx" in msg or "sy" in msg:
                sx, sy = self.renderer.sun_position
                self.renderer.set_sun((float(msg.get("sx", sx)),
                                       float(msg.get("sy", sy))))

    def _render_loop(self):
        """Pipelined step and fetch: each iteration launches this frame's
        steps and its display image, starts that image's copy into a
        pinned host buffer, then encodes the previous frame's, whose copy
        is done or finishing, while the card works.  A captured renderer's
        image is a static buffer that the next replay overwrites; the copy,
        queued before that replay, reads it first."""
        frame_ms = 0.0
        pending = None
        pinned = [None, None]  # two host buffers: one filling, one read
        k = 0
        try:
            while self._running:
                t0 = time.perf_counter()
                self._apply_inputs()
                self.renderer.step(self.camera, self.steps_per_frame)
                img = self.renderer.image(uint8=True)
                if self.preview_scale > 1:
                    s = self.preview_scale
                    img = img[::s, ::s]
                if img.device.type == "cuda" and (
                        pinned[k] is None or pinned[k].shape != img.shape):
                    pinned[k] = torch.empty(img.shape, dtype=img.dtype,
                                            pin_memory=True)
                fetch = _Fetch(img, pinned[k])
                k ^= 1
                if pending is not None:
                    png = _to_png_bytes(pending.numpy(), _FRAME_PNG_LEVEL)
                    with self._lock:
                        self._png = png
                        self.frames += 1
                pending = fetch
                if fetch.event is not None:
                    fetch.event.synchronize()
                # the whole displayed frame: its steps and the fetch
                dt = (time.perf_counter() - t0) * 1e3
                frame_ms = 0.9 * frame_ms + 0.1 * dt if frame_ms else dt
                with self._lock:
                    self._times.append(round(dt, 2))
                    if len(self._times) > 120:
                        self._times.pop(0)
                    spf = (f"  ({self.steps_per_frame} steps/frame)"
                           if self.steps_per_frame > 1 else "")
                    self._stats = (f"{frame_ms:.1f} ms/frame  "
                                   f"{1e3 / max(frame_ms, 1e-6):.1f} fps"
                                   f"{spf}\npos "
                                   f"{np.round(self.camera.position, 1)}")
        except BaseException as e:  # shown by stop() and /stats
            self._error = e
            with self._lock:
                self._stats = f"render loop failed: {e!r}"
            raise

    def _handler(self):
        from http.server import BaseHTTPRequestHandler

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with viewer._lock:
                        png = viewer._png
                    self._send(200, "image/png", png or b"")
                elif self.path.startswith("/stats"):
                    with viewer._lock:
                        s = json.dumps({"text": viewer._stats,
                                        "times": viewer._times,
                                        "frames": viewer.frames})
                    self._send(200, "application/json", s.encode())
                else:
                    self._send(200, "text/html", (_PAGE % ()).encode())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n))
                except ValueError:
                    msg = {}
                if isinstance(msg, dict):
                    with viewer._lock:
                        viewer._inputs.append(msg)
                self._send(200, "text/plain", b"ok")

        return Handler

    def start(self) -> str:
        """Start the render loop and the HTTP server on 127.0.0.1, each on
        a thread of its own; returns the URL."""
        from http.server import ThreadingHTTPServer

        self._srv = ThreadingHTTPServer(("127.0.0.1", self.port),
                                        self._handler())
        self.port = self._srv.server_address[1]
        self._running = True
        self._threads = [
            threading.Thread(target=self._render_loop, daemon=True),
            threading.Thread(target=self._srv.serve_forever, daemon=True)]
        for t in self._threads:
            t.start()
        return f"http://127.0.0.1:{self.port}/"

    def stop(self) -> None:
        """Stop the render loop and the server and wait for both; raises
        if the render loop failed."""
        self._running = False
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
        for t in self._threads:
            t.join()
        self._threads = []
        if self._error is not None:
            raise RuntimeError("the viewer's render loop failed") \
                from self._error

    def serve(self):
        """Serve until interrupted."""
        print(f"viewer: {self.start()}")
        try:
            while self._threads[0].is_alive():
                self._threads[0].join(0.5)
        finally:
            self.stop()


class TerminalViewer:
    """ANSI half-block progressive preview (no interaction)."""

    def __init__(self, renderer, camera, cols: int = 100):
        self.renderer = renderer
        self.camera = camera
        self.cols = cols

    def show(self, steps: int = 50, refresh_every: int = 10):
        done = 0
        while done < steps:
            self.renderer.step(self.camera, refresh_every)
            done += refresh_every
            img = self.renderer.image(uint8=True).cpu().numpy()
            print(f"\x1b[H\x1b[2J{self._ansi(img)}\nsteps {done}/{steps}")

    def _ansi(self, img: np.ndarray) -> str:
        h, w, _ = img.shape
        cols = min(self.cols, w)
        rows = max(2, int(cols * h / w / 2) * 2)
        ys = (np.linspace(0, h - 1, rows)).astype(int)
        xs = (np.linspace(0, w - 1, cols)).astype(int)
        small = img[ys][:, xs]
        lines = []
        for r in range(0, rows - 1, 2):
            line = []
            for c in range(cols):
                tr, tg, tb = small[r, c]
                br, bg, bb = small[r + 1, c]
                line.append(f"\x1b[38;2;{tr};{tg};{tb}m"
                            f"\x1b[48;2;{br};{bg};{bb}m▀")
            lines.append("".join(line) + "\x1b[0m")
        return "\n".join(lines)


def main(argv=None):
    import argparse

    from .cli import _add_common, _build
    from .render import Renderer

    ap = argparse.ArgumentParser(prog="tyrant_tpu_torch.viewer")
    _add_common(ap)
    ap.add_argument("--port", type=int, default=8760)
    ap.add_argument("--terminal", action="store_true")
    ap.add_argument("--steps-per-frame", type=int, default=1)
    ap.add_argument("--preview-scale", type=int, default=1,
                    help="downsample the display fetch (2 = 540p preview)")
    args = ap.parse_args(argv)
    cfg, scene, cam = _build(args)
    r = Renderer(scene, cfg, device=args.device, sun_position=tuple(args.sun))
    if args.terminal:
        TerminalViewer(r, cam).show()
    else:
        HttpViewer(r, cam, port=args.port,
                   steps_per_frame=args.steps_per_frame,
                   preview_scale=args.preview_scale).serve()


if __name__ == "__main__":
    main()
