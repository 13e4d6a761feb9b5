"""Dependency-free web viewer server; this package's own copy of
``easy_gaussian_splatting_tpu/viewer/server.py``.

The server only sees a ``render_func(CameraState) -> ndarray`` closure;
concurrent clients are serialized by a render lock. In training mode a
``/render`` request only posts its camera to a ``DelayRender`` mailbox and
gets the last frame back; the training loop renders the newest request
through ``update_render_image``, so it owns the card's cadence. A stdlib
ThreadingHTTPServer serves a self-contained
orbit-control page that POSTs camera parameters and receives JPEG frames,
plus endpoints for jumping to dataset cameras and recording/exporting
camera-path videos. ``port=0`` binds a free port; ``Viewer.port`` reports
the one bound.
"""

from __future__ import annotations

import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np

from .camera import CameraState, DelayRender, RecordManager, fov2focal

logger = logging.getLogger(__name__)

_PAGE = """<!DOCTYPE html>
<html><head><title>easy_gaussian_splatting_torch viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:sans-serif;overflow:hidden}
#img{position:absolute;top:0;left:0;width:100vw;height:100vh;object-fit:contain}
#hud{position:absolute;top:8px;left:8px;background:#000a;padding:8px;
border-radius:6px;font-size:12px;z-index:2}
button{margin:2px;font-size:12px}
input[type=number]{width:52px}
</style></head><body>
<img id="img"/><div id="hud">
<div>drag: orbit | shift-drag: pan | wheel: zoom</div>
<button onclick="jump(-1)">&lt; cam</button>
<button onclick="jump(1)">cam &gt;</button>
<button onclick="jumpClosest()">closest cam</button>
<br/>rotate
<button onclick="rot('yaw',1)">yaw+</button>
<button onclick="rot('yaw',-1)">yaw-</button>
<button onclick="rot('pitch',1)">pitch+</button>
<button onclick="rot('pitch',-1)">pitch-</button>
<button onclick="rot('roll',1)">roll+</button>
<button onclick="rot('roll',-1)">roll-</button>
<br/>fov <input id="fov" type="range" min="0.3" max="2.2" step="0.05"
value="1.0" style="width:90px"/>
res <select id="res"><option>480</option><option selected>720</option>
<option>960</option></select>
size <input id="cw" type="number" placeholder="W"/>
x <input id="ch" type="number" placeholder="H"/>
<br/>record <button onclick="rec('add')">add keyframe</button>
<button onclick="rec('clear')">clear</button>
<button onclick="rec('export')">export video</button>
dur <input id="dur" type="number" value="10" min="1" step="0.5"/>
fps <input id="fps" type="number" value="30" min="1"/>
<div id="st"></div></div>
<script>
let yaw=0,pitch=0.3,roll=0,radius=4,target=[0,0,0],cams=[],ci=-1,busy=false;
let anim=null;const ROT=5*Math.PI/180;
const img=document.getElementById('img'),st=document.getElementById('st');
fetch('/cameras').then(r=>r.json()).then(j=>{cams=j;
 if(cams.length)({yaw,pitch,radius,target}=orbitOf(cams[0]));});
function orbitOf(c){ // orbit params looking at a dataset camera's target
 const p=c.position,t=c.target||[0,0,0];
 const d=[p[0]-t[0],p[1]-t[1],p[2]-t[2]];const r=Math.hypot(...d);
 return {yaw:Math.atan2(d[0],d[2]),pitch:Math.asin(d[1]/r),radius:r,target:t};}
function animateTo(o,ms){ // smooth jump: ease orbit params to the target
 const from={yaw,pitch,roll,radius,target:[...target]},t0=performance.now();
 anim=()=>{let u=Math.min(1,(performance.now()-t0)/ms);
  const e=u<.5?2*u*u:1-Math.pow(-2*u+2,2)/2; // easeInOutQuad
  yaw=from.yaw+(o.yaw-from.yaw)*e;pitch=from.pitch+(o.pitch-from.pitch)*e;
  roll=from.roll*(1-e); // dataset cameras are roll-free
  radius=from.radius+(o.radius-from.radius)*e;
  for(let i=0;i<3;i++)target[i]=from.target[i]+(o.target[i]-from.target[i])*e;
  if(u>=1)anim=null;};}
function jump(d){if(!cams.length)return; ci=(ci+d+cams.length)%cams.length;
 animateTo(orbitOf(cams[ci]),600); st.textContent='cam '+ci;}
function eye(){return [target[0]+radius*Math.sin(yaw)*Math.cos(pitch),
 target[1]+radius*Math.sin(pitch),target[2]+radius*Math.cos(yaw)*Math.cos(pitch)];}
function jumpClosest(){if(!cams.length)return; const p=eye();let bi=0,bd=1e30;
 cams.forEach((c,i)=>{const d=Math.hypot(c.position[0]-p[0],
  c.position[1]-p[1],c.position[2]-p[2]);if(d<bd){bd=d;bi=i;}});
 ci=bi;animateTo(orbitOf(cams[bi]),600);st.textContent='cam '+bi+' (closest)';}
function rot(axis,s){if(axis=='yaw')yaw+=s*ROT;
 else if(axis=='pitch')pitch=Math.max(-1.5,Math.min(1.5,pitch+s*ROT));
 else roll+=s*ROT;}
function rec(a){const v=view();
 v.duration=parseFloat(document.getElementById('dur').value)||10;
 v.fps=parseFloat(document.getElementById('fps').value)||30;
 fetch('/record/'+a,{method:'POST',body:JSON.stringify(v)})
 .then(r=>r.json()).then(j=>st.textContent=j.status);}
let drag=null,lastMove=0,rung=1,ema=0;
function touch(){lastMove=performance.now();}
img.onmousedown=e=>{drag={x:e.clientX,y:e.clientY,shift:e.shiftKey};touch();};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;touch();
 const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.shift){const s=radius*0.002;
  target[0]-=s*(dx*Math.cos(yaw));target[1]+=s*dy;target[2]+=s*(dx*Math.sin(yaw));}
 else{yaw-=dx*0.005;pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.005));}};
window.onwheel=e=>{radius*=Math.exp(e.deltaY*0.001);touch();};
function interacting(){return anim||drag||performance.now()-lastMove<350;}
function view(){
 const ar=window.innerWidth/window.innerHeight;
 const cw=parseInt(document.getElementById('cw').value);
 const ch=parseInt(document.getElementById('ch').value);
 let h=parseInt(document.getElementById('res').value);
 const v={yaw,pitch,roll,radius,target,
  fov:parseFloat(document.getElementById('fov').value)};
 if(cw>0&&ch>0){ // explicit camera size: server pads to window aspect
  v.width=cw;v.height=ch;v.pad_aspect=ar;}
 else{
  // interaction degradation: drop to a resolution rung (fixed ladder so
  // each size jit-compiles once) + cap SH view-dependence while moving;
  // one full-fidelity frame renders when the camera settles
  if(interacting()&&rung>1){h=Math.max(180,Math.round(h/rung));v.sh_cap=1;}
  // quantize width so window resizes don't mint new jit signatures
  v.width=Math.max(64,Math.round(h*ar/64)*64);v.height=h;}
 return v;}
async function loop(){
 if(anim)anim();
 if(!busy){busy=true;const wasInt=interacting(),t0=performance.now();
  try{const r=await fetch('/render',{method:'POST',body:JSON.stringify(view())});
   const b=await r.blob();img.src=URL.createObjectURL(b);}catch(e){}
  const dt=performance.now()-t0;
  if(wasInt){ // steer the rung toward ~80 ms/frame during interaction
   ema=ema?0.7*ema+0.3*dt:dt;
   if(ema>140&&rung<8){rung*=2;ema=0;}
   else if(ema<35&&rung>1){rung/=2;ema=0;}}
  busy=false;}
 setTimeout(loop,(anim||drag)?16:66);}
rung=2;loop();
</script></body></html>"""


def _orbit_to_camera(p: dict) -> CameraState:
    yaw, pitch, radius = p["yaw"], p["pitch"], p["radius"]
    roll = float(p.get("roll", 0.0))
    target = np.asarray(p.get("target", [0, 0, 0]), np.float64)
    width = int(p.get("width", 960))
    height = int(p.get("height", 720))
    # camera position on the orbit sphere (y-down OpenCV world assumed)
    pos = target + radius * np.array(
        [np.sin(yaw) * np.cos(pitch), np.sin(pitch), np.cos(yaw) * np.cos(pitch)]
    )
    # look-at: z forward towards target, y down
    z = target - pos
    z = z / (np.linalg.norm(z) + 1e-12)
    up = np.array([0.0, -1.0, 0.0])
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-6:
        x = np.array([1.0, 0.0, 0.0])
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    if roll:
        # roll about the view axis: rotate the in-plane basis (x, y)
        c, s = np.cos(roll), np.sin(roll)
        x, y = c * x + s * y, -s * x + c * y
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
    w2c = np.linalg.inv(c2w)
    fov_y = p.get("fov", 1.0)
    f = fov2focal(fov_y, height)
    K = np.array(
        [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]], np.float64
    )
    sh_cap = p.get("sh_cap")
    return CameraState(
        w2c, K, width, height,
        sh_cap=None if sh_cap is None else int(sh_cap),
    )


def pad_to_aspect(image: np.ndarray, aspect: float) -> np.ndarray:
    """Zero-pad an [H, W, 3] image (anchored top-left) so its aspect
    matches the client window — never crops or rescales.

    The same padding the JAX package's viewer applies."""
    h, w = image.shape[:2]
    if w / h < aspect:
        new_h, new_w = h, int(h * aspect)
    elif w / h > aspect:
        new_h, new_w = int(w / aspect), w
    else:
        return image
    out = np.zeros((new_h, new_w, 3), image.dtype)
    out[:h, :w] = image
    return out


class Viewer:
    """Web viewer server. ``render_func`` must return an [H, W, 3] float
    image in [0, 1]."""

    def __init__(
        self,
        render_func: Callable[[CameraState], np.ndarray],
        target_camera_states: List[CameraState],
        host: str = "localhost",
        port: int = 9981,
        in_training_mode: bool = False,
        video_output_dir: Path = Path("./output"),
    ) -> None:
        render_lock = threading.Lock()

        def render_with_lock(camera_state: CameraState) -> np.ndarray:
            with render_lock:
                return render_func(camera_state)

        # the unwrapped closure, for callers that read its per-frame state
        self.base_render_func = render_func
        self.render_func = render_with_lock
        self.in_training_mode = in_training_mode
        self.delay_render: Optional[DelayRender] = None
        if in_training_mode:
            self.delay_render = DelayRender(self.render_func)
        self.target_camera_states = target_camera_states
        self.record = RecordManager(
            self.render_func, duration=10.0, fps=30.0,
            output_dir=Path(video_output_dir),
        )

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/cameras":
                    cams = []
                    for c in viewer.target_camera_states:
                        c2w = np.linalg.inv(c.w2c)
                        cams.append(
                            {
                                "position": c2w[:3, 3].tolist(),
                                "target": (
                                    c2w[:3, 3] + c2w[:3, 2]
                                ).tolist(),
                            }
                        )
                    self._json(cams)
                else:
                    self._json({"error": "not found"}, 404)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                payload = (
                    json.loads(self.rfile.read(length)) if length else {}
                )
                if self.path == "/render":
                    cam = _orbit_to_camera(payload)
                    img = viewer._effective_render(cam)
                    if "pad_aspect" in payload:
                        img = pad_to_aspect(
                            np.asarray(img), float(payload["pad_aspect"])
                        )
                    self._send_jpeg(img)
                elif self.path == "/record/add":
                    viewer.record.camera_states.append(
                        _orbit_to_camera(payload)
                    )
                    self._json(
                        {
                            "status": f"{len(viewer.record.camera_states)} "
                            "keyframes"
                        }
                    )
                elif self.path == "/record/clear":
                    viewer.record.camera_states.clear()
                    self._json({"status": "cleared"})
                elif self.path == "/record/export":
                    if "duration" in payload:
                        viewer.record.duration = max(
                            1.0, float(payload["duration"])
                        )
                    if "fps" in payload:
                        viewer.record.fps = max(1.0, float(payload["fps"]))
                    path = viewer.record.export_video()
                    self._json(
                        {"status": f"exported {path}" if path else "error"}
                    )
                else:
                    self._json({"error": "not found"}, 404)

            def _send_jpeg(self, img: np.ndarray):
                from PIL import Image

                arr = np.clip(np.asarray(img) * 255.0, 0, 255).astype(
                    np.uint8
                )
                buf = io.BytesIO()
                Image.fromarray(arr).save(buf, "JPEG", quality=85)
                body = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "image/jpeg")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(
            target=self.server.serve_forever, daemon=True
        )
        self.thread.start()
        logger.info(f"viewer running at http://{host}:{self.port}")

    def _effective_render(self, camera_state: CameraState) -> np.ndarray:
        """What a ``/render`` request gets: in training mode the mailbox's
        last frame (the request is posted for the loop to render), else a
        render under the lock."""
        if self.delay_render is not None:
            return self.delay_render.get_render_image(camera_state)
        return self.render_func(camera_state)

    def update_render_image(self) -> None:
        """Called by the training loop once per iteration (training mode)."""
        if self.delay_render is not None:
            self.delay_render.update_render_image()

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
