"""Live viewer: MJPEG/PNG HTTP presentation of the interactive renderer
(port of `kajiya_tpu/apps/stream.py`).

The role of the reference's presentation layer (swapchain + winit window +
imgui toggles, `vulkan/swapchain.rs`, `kajiya-simple/src/main_loop.rs`,
`view/src/gui.rs`) on a box with no display: frames render on the card in a
background loop (camera orbit optional) and are presented as a
multipart/x-mixed-replace stream any browser can watch; runtime toggles
(debug modes = the GraphDebugHook picker, exposure, sun) are plain
query-parameter endpoints, mirroring the imgui panel's knobs.

    python -m kajiya_tpu_torch.apps.stream --scene city --width 1920 --height 1080
    # browser: http://host:8080/ui     (control panel: the imgui analog)
    #          /stream                 (live MJPEG view)
    #          /set?debug_mode=normals (any RenderConfig debug mode)
    #          /set?use_rtr=false      (ANY RenderConfig field; rebuilds)
    #          /set?show=ssao          (pass-output picker, GraphDebugHook)
    #          /set?sun=az,el          (sun direction, degrees)
    #          /set?emissive=2.0       (emissive multiplier, runtime.rs:402)
    #          /set?ev=1.5             (exposure shift)
    #          /snap                   (single PNG of the latest frame)
    #          /status                 (config, frame ms, last error,
    #                                   the process's kernel launches)

The render loop and the HTTP server are decoupled through a latest-frame
mailbox (the two-frame swapchain analog: the producer never blocks on a
slow consumer; watchers always get the newest completed frame). Frames
render on CUDA unless `--device cpu` is given. The stream's JPEG parts come
from the port's own encoder (`scene/jpeg.py`, quality 85, 4:2:0, the
settings of the JAX viewer's PIL encode), `/snap` from its PNG encoder
(`scene/png.py`); both run on the host, in the HTTP thread of the request.
"""
from __future__ import annotations

import argparse
import threading
import time
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..ops import _native
from ..scene.jpeg import encode_jpeg
from ..scene.png import encode_png


class FrameMailbox:
    """Latest-frame handoff: producer overwrites, consumers wait for new."""

    def __init__(self):
        self._cond = threading.Condition()
        self._frame = None
        self._seq = 0

    def put(self, frame: np.ndarray):
        with self._cond:
            self._frame = frame
            self._seq += 1
            self._cond.notify_all()

    def get(self, last_seq: int, timeout: float = 5.0):
        with self._cond:
            self._cond.wait_for(lambda: self._seq != last_seq,
                                timeout=timeout)
            return self._frame, self._seq


# outputs-dict keys a watcher can route to the screen: the GraphDebugHook
# analog (`kajiya-rg/src/graph.rs:592-657`, picker `view/src/gui.rs:373-410`).
# "gbuffer.<plane>" reaches into the nested gbuffer dict.
SHOWABLE = ("final", "lit", "shadow", "ssao", "diffuse_gi", "reflections",
            "taa", "gbuffer.albedo", "gbuffer.normal", "gbuffer.depth",
            "gbuffer.roughness", "gbuffer.metallic", "gbuffer.velocity",
            "gbuffer.emissive")


def _displayable(out: dict, show: str) -> np.ndarray:
    """Normalize any routed pass output to a uint8 RGB image: the plane
    comes to the host once, then the JAX viewer's numpy arithmetic."""
    if show.startswith("gbuffer."):
        plane = out["gbuffer"][show.split(".", 1)[1]]
    else:
        plane = out[show]
    img = plane.detach().cpu().numpy()
    img = np.nan_to_num(img.astype(np.float32))
    if show == "gbuffer.normal":
        img = img * 0.5 + 0.5
    elif show == "gbuffer.depth":                  # reversed-Z: scale to max
        img = img / max(float(img.max()), 1e-8)
    elif show == "gbuffer.velocity":
        img = np.concatenate([np.abs(img[..., :2]) * 8.0,
                              np.zeros_like(img[..., :1])], -1)
    elif show in ("lit", "diffuse_gi", "reflections", "gbuffer.emissive"):
        img = (img / (1.0 + img)) ** (1.0 / 2.2)   # quick view tonemap
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] > 3:
        img = img[..., :3]
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)


def _coerce(current, raw: str):
    """Coerce a query-string value to a RenderConfig field's type."""
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, str) or current is None:
        return raw
    raise ValueError(f"field of type {type(current).__name__} not settable")


class ViewerState:
    """Mutable runtime toggles, applied between frames (imgui analog,
    `view/src/gui.rs`: renderer toggles, debug-mode radio, render overrides,
    exposure, sun controller, emissive multiplier, pass debug-hook picker).
    The sun and the emissive multiplier write the renderer's scene tables
    on its device; the emissive change goes through
    `Renderer.set_emissive`, which marks the trace scene stale."""

    def __init__(self, renderer, orbit: float = 0.0):
        self.renderer = renderer
        self.lock = threading.Lock()
        self.ev = 0.0
        self.orbit = orbit          # rad/s camera orbit; 0 = static
        self.paused = False
        self.dirty = False          # config change -> rebuild
        self.show = "final"
        self.cfg_overrides = {}     # pending RenderConfig replacements
        self.frame_ms = 0.0         # wall time of the last frame
        self.frames = 0             # frames presented so far
        self.encode = {}            # the last JPEG / PNG encode's ms, bytes
        self._emissive0 = renderer.ts.gpu.mat_emissive.clone()
        self.emissive_mult = 1.0

    def apply(self, params: dict) -> dict:
        from dataclasses import fields as dc_fields

        from ..renderers import deferred

        cfg = self.renderer.cfg
        known = {f.name: getattr(cfg, f.name) for f in dc_fields(type(cfg))}
        out = {}
        with self.lock:
            for key, vals in params.items():
                raw = vals[0]
                if key == "debug_mode":
                    if raw in deferred.DEBUG_MODES:
                        self.cfg_overrides["debug_mode"] = raw
                        self.dirty = True
                        out["debug_mode"] = raw
                    else:
                        out["error"] = f"unknown debug mode {raw!r}"
                        out["known_debug_modes"] = sorted(deferred.DEBUG_MODES)
                elif key == "show":
                    if raw in SHOWABLE:
                        self.show = out["show"] = raw
                    else:
                        out["error"] = f"unknown output {raw!r}"
                        out["known_outputs"] = list(SHOWABLE)
                elif key == "ev":
                    self.ev = out["ev"] = float(raw)
                    self.cfg_overrides["ev_shift"] = self.ev
                    self.dirty = True
                elif key == "sun":                 # az,el degrees
                    az, el = (float(x) for x in raw.split(","))
                    a, e = np.radians(az), np.radians(el)
                    d = np.array([np.cos(e) * np.sin(a), np.sin(e),
                                  np.cos(e) * np.cos(a)], np.float32)
                    self.renderer.ts.gpu.sun_direction = torch.as_tensor(
                        d, device=self.renderer.device)
                    out["sun"] = d.tolist()
                elif key == "emissive":            # multiplier
                    m = float(raw)
                    self.emissive_mult = out["emissive"] = m
                    self.renderer.set_emissive(self._emissive0 * m)
                elif key == "orbit":
                    self.orbit = out["orbit"] = float(raw)
                elif key == "paused":
                    self.paused = raw in ("1", "true")
                    out["paused"] = self.paused
                elif key in known:                 # any RenderConfig field
                    try:
                        v = _coerce(known[key], raw)
                    except (ValueError, TypeError) as e:
                        out["error"] = f"{key}: {e}"
                        continue
                    self.cfg_overrides[key] = v
                    self.dirty = True
                    out[key] = v
                else:
                    out["error"] = f"unknown param {key!r}"
                    out["known_params"] = sorted(known) + [
                        "show", "sun", "emissive", "orbit", "paused", "ev"]
        return out

    def status(self) -> dict:
        from dataclasses import asdict

        cfg = asdict(self.renderer.cfg)
        cfg = {k: v for k, v in cfg.items() if not isinstance(v, dict)}
        return {"config": cfg, "show": self.show, "ev": self.ev,
                "orbit": self.orbit, "paused": self.paused,
                "emissive": self.emissive_mult,
                "frame_ms_wall": round(self.frame_ms, 1),
                "frames": self.frames, "encode": dict(self.encode),
                "launches": dict(_native.launches),
                "last_error": self.renderer._last_error}

    def step(self, view):
        """One pass of the render loop's body after the camera: apply the
        pending config, draw, wait for the device, and route the chosen
        output to a uint8 image. Returns (outputs, image)."""
        r = self.renderer
        with self.lock:
            if self.dirty:
                r.cfg = replace(r.cfg, **self.cfg_overrides)
                self.cfg_overrides.clear()
                r.rebuild()
                self.dirty = False
            show = self.show
        t1 = time.perf_counter()
        out = r.draw(view)
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)
        img = _displayable(out, show)
        self.frame_ms = (time.perf_counter() - t1) * 1e3
        self.frames += 1
        return out, img


def render_loop(vs: ViewerState, mailbox: FrameMailbox, cam_pos, cam_dir,
                fov: float, stop: threading.Event):
    """Producer: renders frames until `stop`, rebuilding the frame after a
    config change (Renderer.draw keeps presenting the last good frame when
    a frame fails, and reports the error in /status)."""
    from ..core.camera import make_view_constants

    r = vs.renderer
    t0 = time.time()
    while not stop.is_set():
        if vs.paused:
            time.sleep(0.05)
            continue
        orbit = vs.orbit
        pos = np.asarray(cam_pos, np.float64)
        fwd = np.asarray(cam_dir, np.float64)
        if orbit:
            a = orbit * (time.time() - t0)
            c, s = np.cos(a), np.sin(a)
            rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            pos = rot @ pos
            fwd = rot @ fwd
        view = make_view_constants(tuple(pos), tuple(fwd), fov_y_deg=fov,
                                   width=r.cfg.width, height=r.cfg.height,
                                   device=r.device)
        mailbox.put(vs.step(view)[1])


def make_handler(vs: ViewerState, mailbox: FrameMailbox):
    def timed(kind, encode, frame):
        t0 = time.perf_counter()
        data = encode(frame)
        vs.encode[kind] = {"ms": (time.perf_counter() - t0) * 1e3,
                           "bytes": len(data)}
        return data

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):           # quiet
            pass

        def _json(self, obj, code=200):
            import json

            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib name)
            u = urlparse(self.path)
            if u.path == "/ui":
                body = _UI_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif u.path in ("/", "/stream"):
                self.send_response(200)
                self.send_header("Content-Type",
                                 "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                seq = 0
                try:
                    while True:
                        frame, seq = mailbox.get(seq)
                        if frame is None:
                            continue
                        jpg = timed("jpeg", encode_jpeg, frame)
                        self.wfile.write(b"--frame\r\n"
                                         b"Content-Type: image/jpeg\r\n"
                                         + f"Content-Length: {len(jpg)}"
                                         "\r\n\r\n".encode())
                        self.wfile.write(jpg)
                        self.wfile.write(b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    return
            elif u.path == "/snap":
                frame, _ = mailbox.get(-1, timeout=30.0)
                if frame is None:
                    self._json({"error": "no frame yet"}, 503)
                    return
                png = timed("png", encode_png, frame)
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(png)))
                self.end_headers()
                self.wfile.write(png)
            elif u.path == "/set":
                self._json(vs.apply(parse_qs(u.query)))
            elif u.path == "/status":
                self._json(vs.status())
            else:
                self._json({"error": "unknown path"}, 404)

    return Handler


# Minimal single-file control panel: the imgui window of `view/src/gui.rs`
# rendered as HTML. Left: live stream; right: pass picker, debug modes,
# renderer toggles, overrides, exposure/sun/emissive sliders.
_UI_HTML = """<!doctype html><html><head><meta charset="utf-8">
<title>kajiya-tpu (torch)</title><style>
body{margin:0;display:flex;font:13px system-ui;background:#15171a;color:#cfd3d8}
#view{flex:1;display:flex;align-items:center;justify-content:center}
#view img{max-width:100%;max-height:100vh}
#panel{width:300px;padding:12px;background:#1d2025;overflow-y:auto;height:100vh;box-sizing:border-box}
h3{margin:14px 0 6px;font-size:12px;text-transform:uppercase;color:#8a929c}
select,input[type=range]{width:100%}label{display:block;margin:4px 0}
.t label{display:inline-block;width:46%}#st{white-space:pre-wrap;font:11px monospace;color:#79838f}
</style></head><body>
<div id="view"><img src="/stream"></div><div id="panel">
<h3>Output (debug hook)</h3><select id="show" onchange="set('show',this.value)"></select>
<h3>Debug mode</h3><select id="dbg" onchange="set('debug_mode',this.value)"></select>
<h3>Renderers</h3><div class="t" id="toggles"></div>
<h3>Overrides</h3><div class="t" id="ovr"></div>
<label>roughness_scale <span id="rsv">1.0</span>
<input type="range" id="rs" min="0" max="2" step="0.05" value="1"
 oninput="rsv.textContent=this.value" onchange="set('roughness_scale',this.value)"></label>
<h3>Exposure</h3><label>EV <span id="evv">0</span>
<input type="range" min="-6" max="6" step="0.25" value="0"
 oninput="evv.textContent=this.value" onchange="set('ev',this.value)"></label>
<h3>Sun</h3><label>azimuth <span id="azv">35</span>
<input type="range" id="az" min="-180" max="180" step="2" value="35"
 oninput="azv.textContent=this.value" onchange="sun()"></label>
<label>elevation <span id="elv">53</span>
<input type="range" id="el" min="2" max="88" step="2" value="53"
 oninput="elv.textContent=this.value" onchange="sun()"></label>
<h3>Emissive</h3><label>mult <span id="emv">1</span>
<input type="range" min="0" max="8" step="0.25" value="1"
 oninput="emv.textContent=this.value" onchange="set('emissive',this.value)"></label>
<h3>Camera</h3><label>orbit rad/s <span id="orv">0</span>
<input type="range" min="0" max="1.5" step="0.05" value="0"
 oninput="orv.textContent=this.value" onchange="set('orbit',this.value)"></label>
<label><input type="checkbox" onchange="set('paused',this.checked?1:0)"> paused</label>
<h3>Status</h3><div id="st"></div></div><script>
const TOGGLES=['use_rtdgi','use_rtr','use_ssao','use_taa','use_ircache',
 'use_restir_gi','use_motion_blur','sun_soft_shadows','use_wrc'];
const OVR=['force_face_normals','no_normal_maps','no_metal'];
function set(k,v){fetch(`/set?${k}=${encodeURIComponent(v)}`).then(r=>r.json())
 .then(j=>{if(j.error)st.textContent=JSON.stringify(j,null,1);refresh()})}
function sun(){set('sun',az.value+','+el.value)}
function mk(div,names,cfg){div.innerHTML=names.map(n=>`<label><input type="checkbox"
 ${cfg[n]?'checked':''} onchange="set('${n}',this.checked)"> ${n}</label>`).join('')}
function refresh(){fetch('/status').then(r=>r.json()).then(j=>{
 mk(document.getElementById('toggles'),TOGGLES,j.config);
 mk(document.getElementById('ovr'),OVR,j.config);
 st.textContent=`frame ${j.frame_ms_wall} ms (wall)\\n`+
   (j.last_error?('ERR '+j.last_error):'ok')})}
fetch('/set?show=zzz').then(r=>r.json()).then(j=>{show.innerHTML=
 j.known_outputs.map(o=>`<option>${o}</option>`).join('')});
fetch('/set?debug_mode=zzz').then(r=>r.json()).then(j=>{dbg.innerHTML=
 j.known_debug_modes.map(o=>`<option>${o}</option>`).join('')});
refresh();setInterval(refresh,4000);
</script></body></html>"""

def serve(renderer, cam_pos, cam_dir, fov=55.0, port=8080, orbit=0.0,
          block=True):
    """Start the render loop + HTTP server. Returns (server, stop_event)."""
    vs = ViewerState(renderer, orbit=orbit)
    mailbox = FrameMailbox()
    stop = threading.Event()
    t = threading.Thread(target=render_loop,
                         args=(vs, mailbox, cam_pos, cam_dir, fov, stop),
                         daemon=True)
    t.start()
    srv = ThreadingHTTPServer(("0.0.0.0", port), make_handler(vs, mailbox))
    if block:
        try:
            srv.serve_forever()
        finally:
            stop.set()
    else:
        st = threading.Thread(target=srv.serve_forever, daemon=True)
        st.start()
    return srv, stop


def main(argv=None):
    from ..frame import RenderConfig, Renderer
    from .view import build_scene

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scene", default="cornell_box",
                   help="builtin procedural scene name, .ron scene, or "
                        ".gltf/.glb mesh")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--camera", type=float, nargs=6,
                   default=(0.0, 0.0, 2.4, 0.0, 0.0, -1.0))
    p.add_argument("--fov", type=float, default=55.0)
    p.add_argument("--orbit", type=float, default=0.0,
                   help="camera orbit speed, rad/s")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    args = p.parse_args(argv)

    r = Renderer(build_scene(args.scene),
                 RenderConfig(width=args.width, height=args.height),
                 device=args.device)
    print(f"serving http://0.0.0.0:{args.port}/  (/ui /stream /set /snap "
          f"/status) on {r.device}", flush=True)
    serve(r, args.camera[:3], args.camera[3:], fov=args.fov, port=args.port,
          orbit=args.orbit)


if __name__ == "__main__":
    main()
