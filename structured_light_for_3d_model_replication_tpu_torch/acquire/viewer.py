"""Operator web viewer and per-stage artifacts: ``ViewerServer`` and
``StageRecorder``.

The JAX package's viewer (``acquire/viewer.py``): a dependency-free
single-page viewer (inline JS PLY/STL parsers and a 2-D canvas painter
projection; no external assets) served by the stdlib HTTP stack, and a
recorder that persists each stage's artifact so previews are non-blocking.
``merge-360 --artifacts`` writes each chain step's preview cloud as
``merge_step_NN.ply``, ``clean --artifacts`` each clean step's cloud as
``clean_<step>.ply``, ``auto-scan --artifacts`` the sweep's progress; each
appends an entry to ``progress.json``, which the page polls.

Endpoints
---------
  GET /              the viewer page
  GET /api/list      JSON: artifacts ({name, bytes, mtime, kind})
  GET /api/file?name=X  raw bytes of one artifact (PLY/STL/PNG only, no
                     traversal: a name with a directory part is refused)
  GET /api/progress  JSON: the stage-progress feed (progress.json)
  GET /api/poses     JSON: the pending calibration pose review (per-pose
                     reprojection errors), when one is active
  POST /api/poses    {"keep": [names]}: the operator's pose selection;
                     ``calibrate --review`` publishes the errors
                     (``pose_review.json``) and waits for this POST
                     (``pose_selection.json``) before the final solve
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from structured_light_for_3d_model_replication_tpu_torch.io import ply

__all__ = ["ViewerServer", "StageRecorder", "publish_pose_review",
           "await_pose_selection"]

_EXTS = (".ply", ".stl", ".png")
POSE_REVIEW_FILE = "pose_review.json"       # published by calibrate --review
POSE_SELECTION_FILE = "pose_selection.json"  # written back by the operator


def publish_pose_review(artifact_dir: str, errors: dict) -> str:
    """Publish per-pose (cam_px, proj_px) reprojection errors for the
    viewer's review panel; clears any stale selection. Returns the path."""
    os.makedirs(artifact_dir, exist_ok=True)
    sel = os.path.join(artifact_dir, POSE_SELECTION_FILE)
    if os.path.exists(sel):
        os.remove(sel)
    path = os.path.join(artifact_dir, POSE_REVIEW_FILE)
    payload = {"status": "pending",
               "poses": {name: {"cam_px": round(float(ec), 3),
                                "proj_px": round(float(ep), 3)}
                         for name, (ec, ep) in errors.items()}}
    with open(path + ".tmp", "w") as f:
        json.dump(payload, f)
    os.replace(path + ".tmp", path)
    return path


def await_pose_selection(artifact_dir: str, timeout: float = 600.0,
                         poll: float = 0.5) -> list[str] | None:
    """Block until the operator POSTs a selection (or ``timeout``); returns
    the kept pose names, or None on timeout. Consumes the selection file
    and marks the review done."""
    sel = os.path.join(artifact_dir, POSE_SELECTION_FILE)
    # monotonic, never wall-clock: an NTP step or suspend/resume must not
    # stretch or collapse the wait (turntable.wait_for_done's convention)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(sel):
            with open(sel) as f:
                keep = json.load(f).get("keep", [])
            review = os.path.join(artifact_dir, POSE_REVIEW_FILE)
            if os.path.exists(review):
                os.remove(review)
            return [str(k) for k in keep]
        time.sleep(poll)
    # timed out: clear the review too — a pending panel that nothing will
    # ever consume would keep soliciting (and falsely acknowledging)
    # selections after calibration already finished with auto pruning
    review = os.path.join(artifact_dir, POSE_REVIEW_FILE)
    if os.path.exists(review):
        os.remove(review)
    return None


class StageRecorder:
    """Persist per-stage artifacts and progress entries.

    Use as ``merge_360(..., step_callback=StageRecorder(dir).merge_step)``:
    each chain step writes ``merge_step_NN.ply`` (a preview capped at
    ``max_points_per_step`` points by a stride) and appends a progress
    entry."""

    def __init__(self, artifact_dir: str, max_points_per_step: int = 200_000):
        self.dir = artifact_dir
        self.max_points = int(max_points_per_step)
        self._t0 = time.time()
        self._lock = threading.Lock()
        os.makedirs(artifact_dir, exist_ok=True)
        self._progress_path = os.path.join(artifact_dir, "progress.json")
        self._events: list[dict] = []
        self._merge_p: list[np.ndarray] = []
        self._merge_c: list[np.ndarray] = []

    def log_stage(self, stage: str, **info) -> None:
        """Append one progress entry ({stage, t, **info}) and publish the
        whole list atomically."""
        with self._lock:
            self._events.append({"stage": stage, "t": round(time.time() - self._t0, 2),
                                 **info})
            tmp = self._progress_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self._events, f)
            os.replace(tmp, self._progress_path)

    def merge_step(self, i: int, points, colors, total=None) -> None:
        """The merge's ``step_callback``: ``points`` / ``colors`` are the
        newly folded view's arrays and ``total`` the running point count;
        ``i == 0`` seeds the base view without writing an artifact."""
        with self._lock:
            if i == 0:
                self._merge_p, self._merge_c = [], []
            self._merge_p.append(np.asarray(points))
            self._merge_c.append(np.asarray(colors))
            views_p, views_c = list(self._merge_p), list(self._merge_c)
        if i == 0:
            return
        total = int(total) if total is not None else sum(len(p) for p in views_p)
        stride = max(1, total // self.max_points)
        pts = np.concatenate([p[::stride] for p in views_p])
        cols = np.concatenate([c[::stride] for c in views_c])
        path = os.path.join(self.dir, f"merge_step_{i:02d}.ply")
        ply.write_ply(path + ".tmp", pts, cols)   # the viewer may read it mid-merge
        os.replace(path + ".tmp", path)
        self.log_stage("merge", step=i, points=int(total), file=os.path.basename(path))

    def autoscan_progress(self, info: dict) -> None:
        """``auto_scan_360``'s progress hook: one ``autoscan`` entry a view
        (view, turns, angle, elapsed_s, remaining_s), polled by the page."""
        self.log_stage("autoscan", view=info.get("view"),
                       turns=info.get("turns"), angle=info.get("angle"),
                       elapsed_s=round(float(info.get("elapsed_s", 0.0)), 1),
                       remaining_s=round(float(info.get("remaining_s", 0.0)), 1))

    def save_cloud(self, name: str, points: np.ndarray,
                   colors: np.ndarray | None = None) -> str:
        """One stage's cloud as ``<name>.ply`` (capped at
        ``max_points_per_step`` points by a stride; gray 180 without
        colors) and a progress entry. Returns the path."""
        total = len(points)
        stride = max(1, total // self.max_points)
        pts = np.asarray(points)[::stride]
        if colors is None:
            cols = np.full((len(pts), 3), 180, np.uint8)
        else:
            cols = np.asarray(colors)[::stride]
        path = os.path.join(self.dir, name if name.endswith(".ply") else name + ".ply")
        ply.write_ply(path + ".tmp", pts, cols)
        os.replace(path + ".tmp", path)
        self.log_stage("cloud", points=int(total), file=os.path.basename(path))
        return path


class _ViewerHandler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # pragma: no cover - logging detail
        pass

    @property
    def root(self) -> str:
        return self.server.artifact_dir  # type: ignore[attr-defined]

    def _bytes(self, payload: bytes, ctype: str, code: int = 200) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(payload)

    def _json(self, obj, code: int = 200) -> None:
        self._bytes(json.dumps(obj).encode(), "application/json", code)

    def do_GET(self):  # noqa: N802 (stdlib handler contract)
        url = urlparse(self.path)
        if url.path in ("/", "/index.html"):
            self._bytes(_PAGE.encode(), "text/html; charset=utf-8")
        elif url.path == "/api/list":
            items = []
            try:
                for name in sorted(os.listdir(self.root)):
                    if not name.lower().endswith(_EXTS):
                        continue
                    st = os.stat(os.path.join(self.root, name))
                    items.append({"name": name, "bytes": st.st_size,
                                  "mtime": st.st_mtime,
                                  "kind": name.rsplit(".", 1)[-1].lower()})
            except FileNotFoundError:
                pass
            self._json({"artifacts": items})
        elif url.path == "/api/progress":
            p = os.path.join(self.root, "progress.json")
            if os.path.exists(p):
                with open(p, "rb") as f:
                    self._bytes(f.read(), "application/json")
            else:
                self._json([])
        elif url.path == "/api/poses":
            p = os.path.join(self.root, POSE_REVIEW_FILE)
            if os.path.exists(p):
                with open(p, "rb") as f:
                    self._bytes(f.read(), "application/json")
            else:
                self._json({"status": "none", "poses": {}})
        elif url.path == "/api/file":
            name = parse_qs(url.query).get("name", [""])[0]
            # no traversal: basename only, known extensions only
            safe = os.path.basename(name)
            if safe != name or not safe.lower().endswith(_EXTS):
                self._json({"error": "bad name"}, 400)
                return
            full = os.path.join(self.root, safe)
            if not os.path.exists(full):
                self._json({"error": "not found"}, 404)
                return
            ctype = ("image/png" if safe.lower().endswith(".png")
                     else "application/octet-stream")
            with open(full, "rb") as f:
                self._bytes(f.read(), ctype)
        else:
            self._json({"error": "unknown endpoint"}, 404)

    def do_POST(self):  # noqa: N802 (stdlib handler contract)
        url = urlparse(self.path)
        if url.path != "/api/poses":
            self._json({"error": "unknown endpoint"}, 404)
            return
        if not os.path.exists(os.path.join(self.root, POSE_REVIEW_FILE)):
            self._json({"error": "no pose review pending"}, 409)
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(n) or b"{}")
            keep = body["keep"]
            assert isinstance(keep, list)
        except Exception:
            self._json({"error": "body must be JSON {\"keep\": [names]}"}, 400)
            return
        sel = os.path.join(self.root, POSE_SELECTION_FILE)
        with open(sel + ".tmp", "w") as f:
            json.dump({"keep": [str(k) for k in keep],
                       "t": time.time()}, f)
        os.replace(sel + ".tmp", sel)
        self._json({"ok": True, "kept": len(keep)})


class ViewerServer:
    """Threaded artifact viewer on ``http://host:port/`` for one directory."""

    def __init__(self, artifact_dir: str, host: str = "0.0.0.0",
                 port: int = 5051):
        self.artifact_dir = artifact_dir
        self._httpd = ThreadingHTTPServer((host, port), _ViewerHandler)
        self._httpd.artifact_dir = artifact_dir  # type: ignore[attr-defined]
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ViewerServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "ViewerServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# self-contained page: PLY/STL parsing + orbit rendering in vanilla JS on a
# 2D canvas (painter projection) — zero external assets by design
_PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>slscan viewer</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
 body{margin:0;font:14px system-ui,sans-serif;background:#14161a;color:#dde}
 #bar{padding:8px 12px;background:#1d2026;display:flex;gap:12px;align-items:center;flex-wrap:wrap}
 select,button{background:#2a2e36;color:#dde;border:1px solid #444;border-radius:4px;padding:4px 8px}
 #cv{display:block;width:100vw;height:calc(100vh - 46px);touch-action:none}
 #info{opacity:.75}
</style></head><body>
<div id="bar">
 <b>slscan</b>
 <select id="sel"></select>
 <button id="reload">refresh</button>
 <span id="info">pick an artifact</span>
</div>
<div id="poses" style="display:none;padding:8px 12px;background:#171b22">
 <b>Calibration pose review</b>
 <span style="opacity:.7">— untick bad poses, then apply
 (&lt;0.5 px EXCELLENT, &lt;1.0 px GOOD, else POOR)</span>
 <table id="posetab" style="border-collapse:collapse;margin:6px 0"></table>
 <button id="poseapply">Apply selection</button>
 <span id="posemsg"></span>
</div>
<canvas id="cv"></canvas>
<script>
"use strict";
let pts=null, cols=null, tris=null, center=[0,0,0], scale=1;
let rotX=-0.4, rotY=0.6, zoom=1, drag=null;
const cv=document.getElementById('cv'), ctx=cv.getContext('2d');
const info=document.getElementById('info'), sel=document.getElementById('sel');

function fit(){cv.width=cv.clientWidth; cv.height=cv.clientHeight;}
window.addEventListener('resize',()=>{fit();draw();});

async function list(){
  const r=await fetch('api/list'); const j=await r.json();
  const cur=sel.value;
  sel.innerHTML='';
  for(const a of j.artifacts){
    const o=document.createElement('option');
    o.value=a.name; o.textContent=`${a.name} (${(a.bytes/1e6).toFixed(1)} MB)`;
    sel.appendChild(o);
  }
  if(cur) sel.value=cur;
  if(!cur && j.artifacts.length){sel.value=j.artifacts[j.artifacts.length-1].name; load();}
}
sel.onchange=load;
document.getElementById('reload').onclick=list;

function parsePLY(buf){
  const head=new TextDecoder().decode(buf.slice(0,4096));
  const end=head.indexOf('end_header');
  if(end<0) throw 'no PLY header';
  const headerTxt=head.slice(0,end);
  const lines=headerTxt.split('\n').map(s=>s.trim());
  let n=0, props=[], fmt='ascii';
  for(const l of lines){
    if(l.startsWith('format')) fmt=l.split(/\s+/)[1];
    else if(l.startsWith('element vertex')) n=parseInt(l.split(/\s+/)[2]);
    else if(l.startsWith('element')&&!l.includes('vertex')) break;
    else if(l.startsWith('property')&&n>0){const p=l.split(/\s+/);props.push({t:p[1],n:p[2]});}
  }
  const bodyOff=head.indexOf('\n',end)+1;
  const P=new Float32Array(n*3), C=new Uint8Array(n*3).fill(200);
  if(fmt==='ascii'){
    const txt=new TextDecoder().decode(buf.slice(bodyOff));
    const rows=txt.split('\n');
    for(let i=0;i<n;i++){
      const v=rows[i].trim().split(/\s+/).map(Number);
      const m={}; props.forEach((p,k)=>m[p.n]=v[k]);
      P[3*i]=m.x;P[3*i+1]=m.y;P[3*i+2]=m.z;
      if('red' in m){C[3*i]=m.red;C[3*i+1]=m.green;C[3*i+2]=m.blue;}
    }
  } else {
    const little=fmt.includes('little');
    const sz={float:4,float32:4,double:8,uchar:1,uint8:1,char:1,int:4,int32:4,uint:4,short:2,ushort:2};
    let stride=0; const offs=[];
    for(const p of props){offs.push(stride); stride+=sz[p.t]||4;}
    const dv=new DataView(buf,bodyOff);
    const get=(t,off)=> t==='double'?dv.getFloat64(off,little)
      :(t==='uchar'||t==='uint8'||t==='char')?dv.getUint8(off)
      :(t==='short'||t==='ushort')?dv.getUint16(off,little)
      :(t==='int'||t==='int32'||t==='uint')?dv.getInt32(off,little)
      :dv.getFloat32(off,little);
    for(let i=0;i<n;i++){
      const base=i*stride; const m={};
      props.forEach((p,k)=>m[p.n]=get(p.t,base+offs[k]));
      P[3*i]=m.x;P[3*i+1]=m.y;P[3*i+2]=m.z;
      if('red' in m){C[3*i]=m.red;C[3*i+1]=m.green;C[3*i+2]=m.blue;}
    }
  }
  return {P,C,T:null};
}

function parseSTL(buf){
  const dv=new DataView(buf);
  // binary STL: 80-byte header + uint32 count
  const nt=dv.getUint32(80,true);
  if(84+nt*50===buf.byteLength){
    const P=new Float32Array(nt*9), T=new Uint32Array(nt*3);
    for(let i=0;i<nt;i++){
      const b=84+i*50+12;
      for(let v=0;v<3;v++)for(let c=0;c<3;c++)
        P[9*i+3*v+c]=dv.getFloat32(b+12*v+4*c,true);
      T[3*i]=3*i;T[3*i+1]=3*i+1;T[3*i+2]=3*i+2;
    }
    return {P,C:null,T};
  }
  // ascii STL
  const txt=new TextDecoder().decode(buf);
  const v=[...txt.matchAll(/vertex\s+([-\d.eE+]+)\s+([-\d.eE+]+)\s+([-\d.eE+]+)/g)];
  const P=new Float32Array(v.length*3), T=new Uint32Array(v.length);
  v.forEach((m,i)=>{P[3*i]=+m[1];P[3*i+1]=+m[2];P[3*i+2]=+m[3];T[i]=i;});
  return {P,C:null,T};
}

async function load(){
  const name=sel.value; if(!name) return;
  info.textContent='loading '+name+'…';
  const r=await fetch('api/file?name='+encodeURIComponent(name));
  const buf=await r.arrayBuffer();
  if(name.toLowerCase().endsWith('.png')){
    // calibration plots etc. render as plain images
    const img=new Image();
    img.onload=()=>{pts=null;
      ctx.fillStyle='#14161a';ctx.fillRect(0,0,cv.width,cv.height);
      const sc=Math.min(cv.width/img.width,cv.height/img.height,1);
      ctx.drawImage(img,(cv.width-img.width*sc)/2,(cv.height-img.height*sc)/2,
                    img.width*sc,img.height*sc);
      info.textContent=`${name}: ${img.width}x${img.height} image`;};
    img.src=URL.createObjectURL(new Blob([buf],{type:'image/png'}));
    return;
  }
  const parsed=name.toLowerCase().endsWith('.stl')?parseSTL(buf):parsePLY(buf);
  pts=parsed.P; cols=parsed.C; tris=parsed.T;
  const n=pts.length/3;
  let mn=[1e30,1e30,1e30],mx=[-1e30,-1e30,-1e30];
  for(let i=0;i<n;i++)for(let c=0;c<3;c++){
    const x=pts[3*i+c]; if(x<mn[c])mn[c]=x; if(x>mx[c])mx[c]=x;}
  center=[(mn[0]+mx[0])/2,(mn[1]+mx[1])/2,(mn[2]+mx[2])/2];
  scale=2/Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1e-9);
  info.textContent=`${name}: ${n.toLocaleString()} ${tris?'tri-verts':'points'}`;
  draw();
}

function draw(){
  if(!pts){ctx.fillStyle='#14161a';ctx.fillRect(0,0,cv.width,cv.height);return;}
  const w=cv.width,h=cv.height,n=pts.length/3;
  const img=ctx.createImageData(w,h); const d=img.data; const depth=new Float32Array(w*h).fill(-1e30);
  const cy=Math.cos(rotY),sy=Math.sin(rotY),cx=Math.cos(rotX),sx=Math.sin(rotX);
  const s=0.45*Math.min(w,h)*zoom;
  const step=n>2500000?2:1;
  for(let i=0;i<n;i+=step){
    let x=(pts[3*i]-center[0])*scale,y=(pts[3*i+1]-center[1])*scale,z=(pts[3*i+2]-center[2])*scale;
    let X=cy*x+sy*z, Z=-sy*x+cy*z;
    let Y=cx*y-sx*Z, Z2=sx*y+cx*Z;
    const px=(w/2+X*s)|0, py=(h/2-Y*s)|0;
    if(px<0||py<0||px>=w||py>=h) continue;
    const o=py*w+px;
    if(Z2<depth[o]) continue;
    depth[o]=Z2;
    const sh=0.65+0.35*Math.max(-1,Math.min(1,Z2)); const k=4*o;
    if(cols){d[k]=cols[3*i]*sh;d[k+1]=cols[3*i+1]*sh;d[k+2]=cols[3*i+2]*sh;}
    else{d[k]=140*sh+40;d[k+1]=160*sh+40;d[k+2]=200*sh+40;}
    d[k+3]=255;
  }
  ctx.putImageData(img,0,0);
}

cv.addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY];cv.setPointerCapture(e.pointerId);});
cv.addEventListener('pointermove',e=>{
  if(!drag)return;
  rotY+=(e.clientX-drag[0])*0.008; rotX+=(e.clientY-drag[1])*0.008;
  drag=[e.clientX,e.clientY]; draw();});
cv.addEventListener('pointerup',()=>drag=null);
cv.addEventListener('wheel',e=>{e.preventDefault();zoom*=Math.exp(-e.deltaY*0.001);draw();},{passive:false});

async function poll(){
  try{const r=await fetch('api/progress'); const j=await r.json();
    if(j.length){const last=j[j.length-1];
      info.textContent=`stage ${last.stage} ${last.step??''} t=${last.t}s `+(sel.value?`| ${sel.value}`:'');}
  }catch(e){}
  setTimeout(poll,2000);
}

// calibration pose review: per-pose reprojection errors + prune
// (server/gui.py:1211-1250's dialog, non-modal)
const poseBox=document.getElementById('poses'), poseTab=document.getElementById('posetab');
function band(e){return e<0.5?['EXCELLENT','#30a46c']:e<1.0?['GOOD','#ad8b00']:['POOR','#e5484d'];}
async function pollPoses(){
  try{
    const j=await (await fetch('api/poses')).json();
    if(j.status==='pending'){
      if(!poseBox.dataset.shown){
        poseBox.dataset.shown='1'; poseBox.style.display='block';
        poseTab.innerHTML='<tr><th></th><th style="text-align:left">pose</th>'+
          '<th>cam px</th><th>proj px</th><th>quality</th></tr>';
        for(const [name,e] of Object.entries(j.poses).sort()){
          const [q,c]=band(Math.max(e.cam_px,e.proj_px));
          const tr=document.createElement('tr');
          tr.innerHTML=`<td><input type="checkbox" data-pose="${name}" `+
            `${q==='POOR'?'':'checked'}></td><td>${name}</td>`+
            `<td style="text-align:right">${e.cam_px.toFixed(2)}</td>`+
            `<td style="text-align:right">${e.proj_px.toFixed(2)}</td>`+
            `<td style="color:${c}">${q}</td>`;
          poseTab.appendChild(tr);
        }
      }
    } else if(poseBox.dataset.shown){
      poseBox.style.display='none'; delete poseBox.dataset.shown;
    }
  }catch(e){}
  setTimeout(pollPoses,2000);
}
document.getElementById('poseapply').onclick=async()=>{
  const keep=[...poseTab.querySelectorAll('input:checked')].map(i=>i.dataset.pose);
  const r=await fetch('api/poses',{method:'POST',
    headers:{'Content-Type':'application/json'},body:JSON.stringify({keep})});
  document.getElementById('posemsg').textContent=
    r.ok?`kept ${keep.length} poses — calibration resuming`:'apply failed';
};
fit();list();poll();pollPoses();
</script></body></html>
"""
