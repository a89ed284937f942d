"""Live in-browser map viewer: the reference's Pangolin GUI over HTTP.

The reference runs a Pangolin/OpenGL window on a thread of its own
(src/Viewer.cc:162-196: map points, keyframes, the covisibility and
spanning-tree graph, loop edges, the current camera, and menu controls with
the step-by-step gate at :188-189). Here `WebViewer` embeds a
standard-library `http.server` endpoint that hands JSON map snapshots to a
self-contained HTML/canvas page with orbit and zoom, and takes the menu's
control actions (step, step-by-step on/off, release) as POSTs to
`/control`. Attach it with `system.start_webviewer()` (or `system.viewer =
WebViewer()`) and open `viewer.url` in a browser on the host.

Rendering happens in the browser, so the tracking thread pays only for a
rate-limited, downsampled snapshot serialization. The snapshot's JSON is the
JAX package's for the same map and trajectory. `/control` refuses (403) a
POST whose Origin header names another site than the viewer's own
`http://host:port`, so a foreign web page cannot arm the gate and stall
tracking; a request without Origin (urllib, curl) is accepted.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .viewer import LiveViewer

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>hfnet-slam-torch viewer</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
 #bar{position:fixed;top:0;left:0;right:0;padding:6px 10px;background:#1b1b1b;
      display:flex;gap:10px;align-items:center;z-index:2}
 #bar button{background:#333;color:#ddd;border:1px solid #555;padding:3px 10px;
      border-radius:3px;cursor:pointer}
 #bar button:hover{background:#444}
 #status{margin-left:auto;color:#9c9}
 canvas{display:block}
</style></head><body>
<div id="bar">
 <b>hfnet-slam-torch</b>
 <button onclick="ctl('step')">step</button>
 <button id="sbs" onclick="toggleSbs()">step-by-step: off</button>
 <button onclick="ctl('release')">release</button>
 <span id="status">connecting…</span>
</div>
<canvas id="c"></canvas>
<script>
const cv=document.getElementById('c'),cx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight}
rs();addEventListener('resize',rs);
let st=null,rotX=-1.0,rotZ=-1.57,zoom=40,panX=0,panY=0,sbs=false;
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey];
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){panX+=dx;panY+=dy}else{rotZ+=dx*0.008;rotX+=dy*0.008}
 drag=[e.clientX,e.clientY,drag[2]];});
cv.onwheel=e=>{zoom*=Math.exp(-e.deltaY*0.001);e.preventDefault()};
function proj(p){
 // world -> screen: Rz(rotZ) then Rx(rotX), orthographic
 const cz=Math.cos(rotZ),sz=Math.sin(rotZ),cxr=Math.cos(rotX),sxr=Math.sin(rotX);
 const x=p[0]*cz-p[1]*sz, y=p[0]*sz+p[1]*cz;
 const y2=y*cxr-p[2]*sxr;
 return [W/2+panX+x*zoom, H/2+panY+y2*zoom];
}
function seg(a,b,col,w){cx.strokeStyle=col;cx.lineWidth=w;cx.beginPath();
 const p=proj(a),q=proj(b);cx.moveTo(p[0],p[1]);cx.lineTo(q[0],q[1]);cx.stroke()}
function draw(){
 cx.fillStyle='#111';cx.fillRect(0,0,W,H);
 if(!st){requestAnimationFrame(draw);return}
 cx.fillStyle='#8a8a8a';
 for(const p of st.mp){const q=proj(p);cx.fillRect(q[0],q[1],1.4,1.4)}
 if(st.traj&&st.traj.length>1){cx.strokeStyle='#ff7f0e';cx.lineWidth=1.4;
  cx.beginPath();let q=proj(st.traj[0]);cx.moveTo(q[0],q[1]);
  for(const p of st.traj){q=proj(p);cx.lineTo(q[0],q[1])}cx.stroke()}
 for(const e of st.tree)seg(st.kf[e[0]],st.kf[e[1]],'#2ca02c',0.8);
 for(const e of st.loops)seg(st.kf[e[0]],st.kf[e[1]],'#d62728',1.8);
 cx.fillStyle='#1f77b4';
 for(const p of st.kf){const q=proj(p);cx.fillRect(q[0]-2,q[1]-2,4,4)}
 if(st.cam){const q=proj(st.cam);cx.strokeStyle='#0f0';cx.lineWidth=2;
  cx.beginPath();cx.arc(q[0],q[1],6,0,6.283);cx.stroke()}
 requestAnimationFrame(draw);
}
async function poll(){
 try{
  const r=await fetch('state.json');st=await r.json();
  document.getElementById('status').textContent=
   `${st.state} | frame ${st.frames} | ${st.n_kf} KF | ${st.n_mp} pts`+
   (st.fps?` | ${st.fps.toFixed(1)} fps`:'');
 }catch(e){document.getElementById('status').textContent='disconnected'}
 setTimeout(poll,200);
}
async function ctl(cmd){await fetch('control',{method:'POST',
 body:JSON.stringify({cmd:cmd})})}
async function toggleSbs(){sbs=!sbs;
 document.getElementById('sbs').textContent='step-by-step: '+(sbs?'on':'off');
 await fetch('control',{method:'POST',
  body:JSON.stringify({cmd:'step_mode',on:sbs})})}
poll();draw();
</script></body></html>"""


def _snapshot(store, tracker, max_points=20000, traj_tail=4000):
    """The map and tracking state as a JSON-ready dict (what
    MapDrawer::DrawMapPoints / DrawKeyFrames and FrameDrawer's status line
    read on each refresh)."""
    r3 = lambda a: np.round(np.asarray(a, np.float64), 3).tolist()  # noqa: E731
    mp = store.mp_pos[store.mp_valid]
    if len(mp) > max_points:
        mp = mp[:: len(mp) // max_points + 1]
    kfs = store.valid_kf_ids()
    centers, tree = [], []
    loc = {int(k): i for i, k in enumerate(kfs)}
    for k in kfs:
        centers.append(-store.kf_R[k].T @ store.kf_t[k])
        p = int(store.kf_parent[k])
        if p in loc:
            tree.append([loc[int(k)], loc[p]])
    loops = [[loc[int(a)], loc[int(b)]] for a, b in store.loop_edges
             if int(a) in loc and int(b) in loc]
    out = {
        "mp": r3(mp) if len(mp) else [],
        "kf": r3(np.stack(centers)) if centers else [],
        "tree": tree,
        "loops": loops,
        "n_kf": len(kfs),
        "n_mp": int(store.mp_valid.sum()),
        "traj": [],
        "cam": None,
        "state": "\u2014",
    }
    if tracker is not None:
        from ..slam.tracking import _STATE_NAMES

        out["state"] = _STATE_NAMES.get(getattr(tracker, "state", -1), "?")
        traj = getattr(tracker, "trajectory", None) or []
        tail = traj[-traj_tail:]
        if tail:
            cs = np.stack([-R.T @ t for _, R, t in tail])
            out["traj"] = r3(cs)
            out["cam"] = r3(cs[-1])
    return out


class WebViewer(LiveViewer):
    """Serve the live map over HTTP (`system.viewer = WebViewer()`).

    LiveViewer's step-by-step gate and keyframe cadence; in place of PNGs it
    keeps a serialized JSON snapshot that the embedded server hands to the
    page. `port=0` picks a free port; read `viewer.url`. `lock` (the
    mapping worker's map lock in async mode) is held while snapshotting."""

    def __init__(self, host="127.0.0.1", port=0, every_kf: int = 1, max_points: int = 20000,
                 min_period: float = 0.25, lock=None):
        super().__init__(out_path=None, every_kf=every_kf)
        self.max_points = int(max_points)
        self.min_period = float(min_period)
        self.lock = lock
        self._state_bytes = json.dumps(
            {"mp": [], "kf": [], "tree": [], "loops": [], "traj": [], "cam": None,
             "n_kf": 0, "n_mp": 0, "state": "\u2014", "frames": 0}).encode()
        self._wlock = threading.Lock()
        self._last_pub = 0.0
        self._t_prev = None
        self._fps = 0.0

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, _PAGE.encode(), "text/html")
                elif self.path == "/state.json":
                    with viewer._wlock:
                        body = viewer._state_bytes
                    self._send(200, body, "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path != "/control":
                    self._send(404, b"not found", "text/plain")
                    return
                origin = self.headers.get("Origin")
                if origin is not None and origin != viewer.origin:
                    self._send(403, b"cross-origin control refused", "text/plain")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, b"bad json", "text/plain")
                    return
                cmd = msg.get("cmd")
                if cmd == "step":
                    viewer.step(int(msg.get("n", 1)))
                elif cmd == "step_mode":
                    viewer.set_step_by_step(bool(msg.get("on", True)))
                elif cmd == "release":
                    viewer.release()
                else:
                    self._send(400, b"unknown cmd", "text/plain")
                    return
                self._send(200, b"ok", "text/plain")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="hfnet-webviewer", daemon=True)
        self._thread.start()

    @property
    def origin(self) -> str:
        """The page's own origin, `http://host:port`."""
        h, p = self._server.server_address[:2]
        return f"http://{h}:{p}"

    @property
    def url(self) -> str:
        return self.origin + "/"

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)

    def on_frame(self, store, tracker):
        self.frames += 1
        self._gate()
        now = time.monotonic()
        if self._t_prev is not None and now > self._t_prev:
            inst = 1.0 / (now - self._t_prev)
            self._fps = 0.9 * self._fps + 0.1 * inst if self._fps else inst
        self._t_prev = now
        n_kf = int(store.kf_valid.sum())
        fresh_kf = n_kf - self._last_kf_count >= self.every_kf
        if not fresh_kf and now - self._last_pub < self.min_period:
            return
        self._last_kf_count, self._last_pub = n_kf, now
        self.publish(store, tracker)

    def publish(self, store, tracker):
        """Serialize the map and tracking state now and serve it: on_frame
        calls it at the keyframe cadence; after finish() it shows the final
        map."""
        try:
            if self.lock is not None:
                with self.lock:
                    snap = _snapshot(store, tracker, self.max_points)
            else:
                snap = _snapshot(store, tracker, self.max_points)
            snap["frames"] = self.frames
            snap["fps"] = round(self._fps, 2)
            body = json.dumps(snap).encode()
            with self._wlock:
                self._state_bytes = body
            self.renders += 1
        except Exception:
            pass  # observability must never take down tracking
