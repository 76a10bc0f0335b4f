"""Dependency-free web viewer for trained scenes, port of
threedgrut_tpu/playground/web_viewer.py (the reference system's polyscope
and viser GUIs): a stdlib HTTP server and an HTML/JS client with the same
control surface.

  - quick presets (Fast / Balanced / High Quality);
  - render settings: channel (color, density, depth), mode (trace, hybrid,
    raster), camera model (pinhole, fisheye), FOV, gamma, max bounces,
    SPP, tonemap, denoiser;
  - depth of field: aperture and focus distance;
  - material editor (kind, base colour, metallic, roughness, IOR);
  - primitive editor (visibility, translate, rotate, scale, material,
    duplicate, remove);
  - camera trajectory: add and clear keyframes, save and load JSON,
    render a video.

Endpoints: GET `/` (the page), `/render?yaw=&pitch=&radius=` (a JPEG),
`/state` and `/info` (the viewer's state as JSON), `/train_status` (with
a live trainer, gui.TrainingGUI); POST `/config`, `/preset`, `/material`,
`/primitive`, `/traj` (a JSON body; the new state back, or a 400 with the
error).

Trace and hybrid frames go through Engine.render_fitted, which grows the
candidate capacity until the frame fits. Raster mode renders the Gaussians
alone through frame-coherent inference (render/infer.py): a refresh frame
(exact, with the census and compaction) whenever the camera has drifted
more than ~7 degrees from the last refresh's camera or every 8 frames,
compacted frames between. Unlike the JAX viewer, the drift is measured
from the last refresh (the JAX viewer moves its reference on every
compacted frame, ROADMAP C4), and each capacity grows on overflow up to
its ceiling, past which the frame raises instead of being shown truncated
(the JAX viewer shows the fifth truncated attempt, ROADMAP C16).

Usage: viewer = WebViewer(engine, scene=scene_graph); viewer.serve(8080)
"""
from __future__ import annotations

import dataclasses
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from threedgrut_torch.cameras import (FisheyeCamera, PinholeCamera, look_at,
                                      pose_from_matrix)
from threedgrut_torch.trainer import MAX_ISECT_CAPACITY

_PAGE = """<!DOCTYPE html>
<html><head><title>threedgrut_torch playground</title>
<style>
body{margin:0;background:#111;color:#eee;font-family:monospace;display:flex}
#panel{width:300px;padding:10px;overflow-y:auto;height:100vh;
  background:#1a1a1a;font-size:12px}
#panel h3{margin:10px 0 4px;color:#8cf;cursor:pointer}
#panel label{display:block;margin:3px 0}
#panel input[type=range]{width:120px;vertical-align:middle}
#panel select,#panel input[type=number]{background:#222;color:#eee;
  border:1px solid #444;width:70px}
#panel button{background:#333;color:#eee;border:1px solid #555;margin:2px;
  cursor:pointer}
#view{align-self:flex-start}
#hud{position:fixed;top:8px;right:8px;color:#8f8}
.sec{display:block}
</style></head>
<body>
<div id="panel"></div>
<img id="view" width="%(w)d" height="%(h)d" draggable="false">
<div id="hud">drag orbit | wheel zoom</div>
<script>
let S=null;  // mirrored server state
let yaw=0.6,pitch=0.4,radius=4.0,drag=false,lx=0,ly=0,pending=false,dirty=false;
const img=document.getElementById('view');
function refresh(){
  if(pending){dirty=true;return} pending=true;
  fetch(`/render?yaw=${yaw}&pitch=${pitch}&radius=${radius}`)
    .then(r=>r.blob()).then(b=>{img.src=URL.createObjectURL(b);
      pending=false; if(dirty){dirty=false;refresh();}});
}
function post(path,body){
  return fetch(path,{method:'POST',body:JSON.stringify(body)})
    .then(r=>r.json()).then(s=>{S=s;buildPanel();refresh();});
}
function cfg(k,v){post('/config',{[k]:v});}
function slider(label,value,min,max,step,oninput){
  return `<label>${label} <input type=range min=${min} max=${max} `+
    `step=${step} value=${value} onchange="(${oninput})(this.value)">`+
    `<span>${value}</span></label>`;
}
function buildPanel(){
  const c=S.config;let h='';
  h+='<h3>Quick Settings</h3><div class=sec>';
  h+='<button onclick="post(\\'/preset\\',{name:\\'fast\\'})">Fast</button>';
  h+='<button onclick="post(\\'/preset\\',{name:\\'balanced\\'})">Balanced</button>';
  h+='<button onclick="post(\\'/preset\\',{name:\\'high\\'})">High Quality</button></div>';
  h+='<h3>Render</h3><div class=sec>';
  h+=`<label>Channel <select onchange="cfg('channel',this.value)">`+
     ['color','density','depth'].map(x=>`<option ${S.channel==x?'selected':''}>${x}</option>`).join('')+'</select></label>';
  h+=`<label>Mode <select onchange="cfg('mode',this.value)">`+
     ['trace','hybrid','raster'].map(x=>`<option ${S.mode==x?'selected':''}>${x}</option>`).join('')+'</select></label>';
  h+=`<label>Camera <select onchange="cfg('camera',this.value)">`+
     ['pinhole','fisheye'].map(x=>`<option ${S.camera==x?'selected':''}>${x}</option>`).join('')+'</select></label>';
  h+=slider('FOV°',S.fov_deg,20,120,1,'v=>cfg(\\'fov_deg\\',+v)');
  h+=slider('Gamma',c.gamma,0.5,3,0.05,'v=>cfg(\\'gamma\\',+v)');
  h+=slider('Bounces',c.max_bounces,1,8,1,'v=>cfg(\\'max_bounces\\',+v)');
  h+=slider('SPP',c.spp,1,16,1,'v=>cfg(\\'spp\\',+v)');
  h+=`<label><input type=checkbox ${c.tonemap?'checked':''} `+
     `onchange="cfg('tonemap',this.checked)">Filmic tonemap</label>`;
  h+=`<label><input type=checkbox ${c.denoise?'checked':''} `+
     `onchange="cfg('denoise',this.checked)">Denoiser</label>`;
  h+=`<label>Filter <select onchange="cfg('denoiser',this.value)">`+
     ['atrous','bilateral'].map(x=>`<option ${c.denoiser==x?'selected':''}>${x}</option>`).join('')+'</select></label></div>';
  h+='<h3>Depth of Field</h3><div class=sec>';
  h+=`<label><input type=checkbox ${c.use_dof?'checked':''} `+
     `onchange="cfg('use_dof',this.checked)">Enable</label>`;
  h+=slider('Aperture',c.aperture,0,0.2,0.002,'v=>cfg(\\'aperture\\',+v)');
  h+=slider('Focus z',c.focus_z,0.2,10,0.1,'v=>cfg(\\'focus_z\\',+v)')+'</div>';
  h+='<h3>Materials</h3><div class=sec>';
  S.scene.materials.forEach((m,i)=>{
    h+=`<details><summary>#${i} ${['diffuse','mirror','glass','pbr'][m.kind]}`+
       `${m.has_texture?' [tex]':''}</summary>`;
    h+=`<label>Kind <select onchange="post('/material',{id:${i},kind:this.selectedIndex})">`+
       ['diffuse','mirror','glass','pbr'].map((x,k)=>`<option ${m.kind==k?'selected':''}>${x}</option>`).join('')+'</select></label>';
    h+=`<label>Color <input type=color value="${rgbhex(m.base_color)}" `+
       `onchange="post('/material',{id:${i},base_color:hexrgb(this.value)})"></label>`;
    h+=slider('Metallic',m.metallic,0,1,0.02,`v=>post('/material',{id:${i},metallic:+v})`);
    h+=slider('Roughness',m.roughness,0,1,0.02,`v=>post('/material',{id:${i},roughness:+v})`);
    h+=slider('IOR',m.ior,1,2.5,0.02,`v=>post('/material',{id:${i},ior:+v})`);
    h+=`</details>`;});
  h+='</div><h3>Primitives</h3><div class=sec>';
  for(const [n,p] of Object.entries(S.scene.primitives)){
    h+=`<details><summary>${n} (${p.num_faces}f)</summary>`;
    h+=`<label><input type=checkbox ${p.visible?'checked':''} `+
       `onchange="post('/primitive',{name:'${n}',visible:this.checked})">visible</label>`;
    ['x','y','z'].forEach((ax,k)=>{
      h+=slider('t'+ax,p.translation[k],-3,3,0.05,
        `v=>{let t=${JSON.stringify(p.translation)};t[${k}]=+v;`+
        `post('/primitive',{name:'${n}',translation:t})}`);});
    h+=slider('rot z',p.rotation_euler[2],-3.14,3.14,0.05,
      `v=>{let r=${JSON.stringify(p.rotation_euler)};r[2]=+v;`+
      `post('/primitive',{name:'${n}',rotation_euler:r})}`);
    h+=slider('scale',p.scale,0.1,4,0.05,
      `v=>post('/primitive',{name:'${n}',scale:+v})`);
    h+=`<label>Material <input type=number value="${p.material_id==null?-1:p.material_id}" `+
       `onchange="post('/primitive',{name:'${n}',material_id:+this.value<0?null:+this.value})"></label>`;
    h+=`<button onclick="post('/primitive',{name:'${n}',op:'duplicate'})">duplicate</button>`;
    h+=`<button onclick="post('/primitive',{name:'${n}',op:'remove'})">remove</button>`;
    h+=`</details>`;}
  if(S.has_training){
    h+='<h3>Training</h3><div class=sec id=trainsec>';
    h+='<div id=trainline>waiting for log points...</div>';
    h+='<canvas id=spark width=280 height=80 style="background:#222"></canvas>';
    h+='<label><input type=checkbox id=livechk checked>live view (5s)</label>';
    h+='</div>';
  }
  h+='</div><h3>Trajectory Video</h3><div class=sec>';
  h+=`<button onclick="post('/traj',{op:'add',yaw:yaw,pitch:pitch,radius:radius})">Add Camera</button>`;
  h+=`<button onclick="post('/traj',{op:'clear'})">Reset</button>`;
  h+=`<button onclick="post('/traj',{op:'render'})">Render Video</button>`;
  h+=`<div>${S.trajectory.length} cameras`+
     `${S.video_status?' | '+S.video_status:''}</div>`;
  h+=`<button onclick="post('/traj',{op:'save'})">Save</button>`;
  h+=`<button onclick="post('/traj',{op:'load'})">Load</button></div>`;
  document.getElementById('panel').innerHTML=h;
}
function rgbhex(c){return '#'+c.map(x=>Math.round(x*255)
  .toString(16).padStart(2,'0')).join('');}
function hexrgb(s){return [1,3,5].map(i=>parseInt(s.substr(i,2),16)/255);}
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
  yaw+=(e.clientX-lx)*0.01;pitch+=(e.clientY-ly)*0.01;
  pitch=Math.max(-1.5,Math.min(1.5,pitch));lx=e.clientX;ly=e.clientY;
  refresh();};
window.onwheel=e=>{radius*=Math.exp(e.deltaY*0.001);refresh();};
fetch('/state').then(r=>r.json()).then(s=>{S=s;buildPanel();refresh();
  if(S.has_training)setInterval(pollTrain,2000);});
function pollTrain(){
  fetch('/train_status').then(r=>r.json()).then(t=>{
    const h=t.history||[];if(!h.length)return;
    const last=h[h.length-1];
    const el=document.getElementById('trainline');
    if(el)el.innerHTML=`step ${last.step} | loss ${last.loss.toFixed(4)}`+
      ` | psnr ${last.psnr.toFixed(2)} dB<br>particles ${last.particles}`+
      ` | ${last.it_s.toFixed(1)} it/s`;
    const cv=document.getElementById('spark');
    if(cv){const g=cv.getContext('2d');g.clearRect(0,0,280,80);
      const ps=h.map(x=>x.psnr),lo=Math.min(...ps),hi=Math.max(...ps)+1e-6;
      g.strokeStyle='#8f8';g.beginPath();
      ps.forEach((p,i)=>{const x=i*280/Math.max(1,ps.length-1),
        y=76-72*(p-lo)/(hi-lo);i?g.lineTo(x,y):g.moveTo(x,y);});
      g.stroke();g.fillStyle='#8f8';g.font='10px monospace';
      g.fillText(hi.toFixed(1),2,10);g.fillText(lo.toFixed(1),2,78);}
    const chk=document.getElementById('livechk');
    if(chk&&chk.checked&&(!window._lastLive
        ||(Date.now()-window._lastLive)>5000)){
      window._lastLive=Date.now();refresh();}
  }).catch(()=>{});
}
</script></body></html>
"""

_PRESETS = {
    # (spp, max_bounces, denoise): the reference GUI's Fast / Balanced /
    # High Quality.
    "fast": dict(spp=1, max_bounces=2, denoise=False),
    "balanced": dict(spp=2, max_bounces=4, denoise=False),
    "high": dict(spp=4, max_bounces=6, denoise=True),
}
# Raster mode: a refresh after this many compacted frames, or once the
# camera has drifted this far (yaw + pitch in radians plus the relative
# radius change) from the last refresh's camera.
REFRESH_FRAMES = 8
REFRESH_DRIFT = 0.12
# Raster mode's census threshold: particles whose largest composite weight
# stays at or below 1/255 are left out of the compacted scene.
VISIBILITY_THRESHOLD = 1.0 / 255.0


def _ceil256(x: int) -> int:
    return -(-x // 256) * 256


def drift(key, ref) -> float:
    """The camera change from `ref` to `key` ((yaw, pitch, radius))."""
    return (abs(key[0] - ref[0]) + abs(key[1] - ref[1])
            + abs(key[2] - ref[2]) / max(ref[2], 1e-3))


class WebViewer:
    """The viewer of an Engine (or of gui.TrainingGUI's live-trainer
    proxy) and, optionally, of the SceneGraph it renders. `grown` lists
    every capacity a frame grew: (mode, capacity name, new value)."""

    def __init__(self, engine, resolution: Tuple[int, int] = (400, 400),
                 target=(0.0, 0.0, 0.0), fov_deg: float = 60.0,
                 scene=None, traj_path: str = "trajectory.json",
                 video_path: str = "trajectory.mp4", status_fn=None):
        self.engine = engine
        # A live trainer's status (gui.TrainingGUI): a callable returning a
        # dict with a `history` list; enables the Training panel and
        # /train_status.
        self.status_fn = status_fn
        self.scene = scene
        self.resolution = tuple(resolution)
        self.target = np.asarray(target, np.float32)
        self.fov_deg = float(fov_deg)
        self.camera_kind = "pinhole"
        self.channel = "color"
        self.mode = "trace"
        self.trajectory = []        # dicts of yaw, pitch, radius
        self.traj_path = traj_path
        self.video_path = video_path
        self.video_status = ""
        self.grown = []
        self._lock = threading.Lock()
        self._raster_cache = None   # the compacted scene and refresh key
        self._raster_caps = None    # [isect_cap, n_compact, compact_cap]
        self._sync_scene()

    # -- scene edits feed the engine's stacked buffers ----------------------
    def _sync_scene(self):
        if self.scene is not None:
            self.engine.mesh = self.scene.mesh()
            self.engine.materials = self.scene.materials()

    def _camera(self):
        dev = self.engine.device
        w, h = self.resolution
        f = 0.5 * w / np.tan(0.5 * np.radians(self.fov_deg))

        def t(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        if self.camera_kind == "fisheye":
            return FisheyeCamera(
                focal=t([f, f]), principal=t([w / 2, h / 2]),
                radial=t([0.0] * 4),
                max_angle=t(np.radians(0.75 * self.fov_deg)))
        return PinholeCamera(
            focal=t([f, f]), principal=t([w / 2, h / 2]),
            radial=t([0.0] * 6), tangential=t([0.0] * 2),
            thin_prism=t([0.0] * 4))

    def _pose(self, yaw, pitch, radius) -> torch.Tensor:
        eye = self.target + radius * np.array([
            np.cos(pitch) * np.cos(yaw), np.cos(pitch) * np.sin(yaw),
            np.sin(pitch)], np.float32)
        return torch.as_tensor(
            look_at(eye, self.target, np.array([0, 0, 1], np.float32)),
            device=self.engine.device)

    def render_outputs(self, yaw: float, pitch: float, radius: float):
        """The current mode's outputs (rgb, opacity, depth) at the orbit
        camera (yaw, pitch, radius) about the target."""
        T = self._pose(yaw, pitch, radius)
        with self._lock:
            if self.mode == "raster":
                return self._render_raster(yaw, pitch, radius, T)
            grown = []
            out = self.engine.render_fitted(
                self._camera(), T, self.resolution,
                hybrid=self.mode == "hybrid", grown=grown)
            self.grown += [(self.mode, "candidate_capacity", c)
                           for c in grown]
            return out

    def render_frame(self, yaw: float, pitch: float,
                     radius: float) -> np.ndarray:
        """The current channel of a frame as [H, W, 3] in [0, 1]."""
        out = self.render_outputs(yaw, pitch, radius)
        if self.channel == "density":
            op = out["opacity"].cpu().numpy()
            return np.repeat(np.clip(op, 0, 1)[..., None], 3, -1)
        if self.channel == "depth":
            from threedgrut_torch.utils.writer import jet_colormap
            d = out["depth"].cpu().numpy()
            inv = np.where(d > 1e-6, 1.0 / np.maximum(d, 1e-6), 0.0)
            return jet_colormap(inv / max(1e-6, float(inv.max())))
        return np.clip(out["rgb"].cpu().numpy(), 0.0, 1.0)

    # -- raster fast preview (frame-coherent inference) ---------------------
    def _grow(self, i: int, ceiling: int, what: str) -> None:
        cur = self._raster_caps[i]
        if cur >= ceiling:
            raise RuntimeError(
                f"raster frame overflows its {what} at the ceiling {cur}: "
                f"the frame would be truncated")
        self._raster_caps[i] = min(2 * cur, ceiling)
        self.grown.append(("raster", what, self._raster_caps[i]))

    def _render_raster(self, yaw, pitch, radius, T):
        """Mode 'raster': the Gaussians alone (meshes are ignored) through
        render/infer.py. Each capacity (intersections, compacted rows,
        compacted intersections) doubles on overflow and the frame is
        rendered again, up to its ceiling, where the frame raises."""
        from threedgrut_torch.render import infer
        P = self.engine.gaussians
        n = int(P[0].shape[0])
        if self._raster_caps is None:
            cap = min(1 << 22, max(1 << 16, _ceil256(48 * n)))
            self._raster_caps = [cap, min(n, max(256, _ceil256(n // 2))),
                                 _ceil256(cap // 2)]
        cam = self._camera()
        pose = pose_from_matrix(T)
        aux = self.channel in ("density", "depth")
        key = (yaw, pitch, radius)
        dev = self.engine.device
        sh = self.engine.cfg.sh_degree
        while True:
            cap, n_c, cap_c = self._raster_caps
            cache = self._raster_cache
            if (cache is None or cache["frames"] >= REFRESH_FRAMES
                    or drift(key, cache["key"]) > REFRESH_DRIFT):
                out, ovf, scene = infer.refresh(
                    *P, cam, pose, self.resolution, cap, n_c, sh_degree=sh,
                    T_to_world=T, visibility_threshold=VISIBILITY_THRESHOLD,
                    device=dev)
                if bool(ovf):
                    self._raster_cache = None
                    self._grow(0, MAX_ISECT_CAPACITY, "isect_capacity")
                    continue
                if bool(scene.overflow):
                    self._raster_cache = None
                    self._grow(1, n, "n_compact")
                    continue
                self._raster_cache = dict(scene=scene, key=key, frames=0)
            else:
                out, covf = infer.render_compact(
                    cache["scene"], cam, pose, self.resolution, cap_c,
                    sh_degree=sh, T_to_world=T, aux_outputs=aux, device=dev)
                if bool(covf):
                    self._grow(2, MAX_ISECT_CAPACITY, "compact_capacity")
                    continue
                # The reference camera stays the last refresh's.
                cache["frames"] += 1
            return dict(rgb=out.rgb, opacity=out.opacity, depth=out.depth)

    def _encode_jpeg(self, rgb: np.ndarray) -> bytes:
        from PIL import Image
        buf = io.BytesIO()
        Image.fromarray((rgb * 255).astype(np.uint8)).save(
            buf, format="JPEG", quality=90)
        return buf.getvalue()

    # -- state and edits -----------------------------------------------------
    def describe(self) -> dict:
        return dict(
            config=dataclasses.asdict(self.engine.cfg),
            fov_deg=self.fov_deg, camera=self.camera_kind,
            channel=self.channel, mode=self.mode,
            resolution=list(self.resolution),
            scene=(self.scene.describe() if self.scene is not None
                   else dict(primitives={}, materials=[])),
            trajectory=self.trajectory,
            video_status=self.video_status,
            has_training=self.status_fn is not None)

    def apply_config(self, body: dict) -> None:
        fields = {f.name for f in dataclasses.fields(self.engine.cfg)}
        with self._lock:
            for k, v in body.items():
                if k == "fov_deg":
                    self.fov_deg = float(v)
                elif k == "camera":
                    self.camera_kind = str(v)
                elif k == "channel":
                    self.channel = str(v)
                elif k == "mode":
                    self.mode = str(v)
                elif k in fields:
                    cur = getattr(self.engine.cfg, k)
                    setattr(self.engine.cfg, k, type(cur)(v))
                else:
                    raise KeyError(k)

    def apply_material(self, body: dict) -> None:
        mid = int(body.pop("id"))
        with self._lock:
            self.scene.set_material(mid, **body)
            self._sync_scene()

    def apply_primitive(self, body: dict) -> None:
        name = body.pop("name")
        op = body.pop("op", None)
        with self._lock:
            if op == "duplicate":
                self.scene.duplicate(name)
            elif op == "remove":
                self.scene.remove(name)
            elif body:
                self.scene.update(name, **body)
            self._sync_scene()

    def apply_traj(self, body: dict):
        """A trajectory edit; `render` starts the video in a thread and
        returns it."""
        op = body.get("op")
        if op == "add":
            self.trajectory.append(dict(
                yaw=float(body["yaw"]), pitch=float(body["pitch"]),
                radius=float(body["radius"])))
        elif op == "clear":
            self.trajectory = []
        elif op == "save":
            with open(self.traj_path, "w") as f:
                json.dump(self.trajectory, f)
            self.video_status = f"saved {self.traj_path}"
        elif op == "load":
            with open(self.traj_path) as f:
                self.trajectory = json.load(f)
            self.video_status = f"loaded {len(self.trajectory)} cams"
        elif op == "render":
            if len(self.trajectory) < 2:
                self.video_status = "need >= 2 cameras"
                return None
            t = threading.Thread(
                target=self.render_video,
                kwargs=dict(n_frames=int(body.get("frames", 120))),
                daemon=True)
            self.video_status = "rendering..."
            t.start()
            return t
        else:
            raise KeyError(op)
        return None

    def render_video(self, n_frames: int = 120, fps: int = 30) -> str:
        """Render the keyframe trajectory to `video_path`; the path written
        (video.render_video) goes to `video_status`, and so does a
        failure, which raises."""
        from threedgrut_torch.playground.video import (keyframe_trajectory,
                                                       render_video)
        kf = [self._pose(c["yaw"], c["pitch"], c["radius"]).cpu().numpy()
              for c in self.trajectory]
        traj = keyframe_trajectory(kf, n_frames, target=tuple(self.target))
        try:
            with self._lock:
                path = render_video(self.engine, self._camera(), traj,
                                    self.resolution, self.video_path,
                                    fps=fps, hybrid=self.mode == "hybrid")
        except Exception as e:
            self.video_status = f"failed: {e!r}"
            raise
        self.video_status = f"wrote {path}"
        return path

    # -- HTTP ----------------------------------------------------------------
    def make_handler(viewer):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, obj, code=200):
                self._send(json.dumps(obj).encode(), "application/json",
                           code)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    w, h = viewer.resolution
                    self._send((_PAGE % {"w": w, "h": h}).encode(),
                               "text/html")
                elif u.path == "/render":
                    q = parse_qs(u.query)

                    def val(k, dflt):
                        return float(q.get(k, [dflt])[0])
                    rgb = viewer.render_frame(
                        val("yaw", 0.6), val("pitch", 0.4),
                        val("radius", 4.0))
                    self._send(viewer._encode_jpeg(rgb), "image/jpeg")
                elif u.path in ("/state", "/info"):
                    self._json(viewer.describe())
                elif u.path == "/train_status":
                    if viewer.status_fn is None:
                        self._json({"error": "not training"}, 404)
                    else:
                        self._json(viewer.status_fn())
                else:
                    self._json({"error": "unknown"}, 404)

            def do_POST(self):
                u = urlparse(self.path)
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                handlers = {"/config": viewer.apply_config,
                            "/preset": lambda b: viewer.apply_config(
                                _PRESETS[b["name"]]),
                            "/material": viewer.apply_material,
                            "/primitive": viewer.apply_primitive,
                            "/traj": viewer.apply_traj}
                if u.path not in handlers:
                    self._json({"error": "unknown"}, 404)
                    return
                try:
                    handlers[u.path](body)
                except (KeyError, ValueError, TypeError, IndexError,
                        AttributeError, OSError) as e:
                    # An edit the viewer cannot apply: the client gets the
                    # error and the state is unchanged.
                    self._json({"error": repr(e)}, 400)
                    return
                self._json(viewer.describe())
        return Handler

    def serve(self, port: int = 8080, blocking: bool = True,
              host: str = "0.0.0.0") -> ThreadingHTTPServer:
        """Serve on (host, port): forever, or with `blocking=False` from a
        daemon thread (the caller shuts the returned server down)."""
        server = ThreadingHTTPServer((host, port), self.make_handler())
        print(f"viewer at http://localhost:{server.server_address[1]}/",
              flush=True)
        if blocking:
            server.serve_forever()
        else:
            threading.Thread(target=server.serve_forever,
                             daemon=True).start()
        return server
