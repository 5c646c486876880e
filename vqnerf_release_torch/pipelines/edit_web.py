"""Browser frontend for the material-editing server (counterpart of
vqnerf_release_tpu/pipelines/edit_web.py, with its routes, JSON and page).

A single-page UI on stdlib http.server: click a pixel to select its
material segment in every view, or paint or upload a mask; pick a material
or BRDF values and an illumination; submit; poll for the result. It speaks
the status-file protocol of ``edit_server_loop`` (pipelines/edit.py), so
the compute server is untouched.

  * ``views_dir``: a test pass (e.g. pd_vq) with ``batch%09d/`` directories
    holding ``pred_rgb.png``, ``embed_map.png`` and the raw id map
    ``pred_embed.npy``;
  * ``root``: the protocol root shared with the edit server (status/,
    edited/, pd_edited/).

Masks travel as PNGs, encoded and decoded by the port's own codec
(``data/io.py``).
"""

import base64
import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from os.path import isdir, isfile, join

import numpy as np

from ..data import io as vio
from .edit_client import MATERIAL_DB, auto_select_mask, submit_edit

__all__ = ["EditSession", "make_handler", "serve_edit_ui"]

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>VQ-NeRF material editing</title>
<style>
 body{font-family:sans-serif;margin:1em;background:#181818;color:#ddd}
 img{image-rendering:pixelated;border:1px solid #444;max-width:45vw}
 .row{display:flex;gap:1em;flex-wrap:wrap}
 select,button,input{font-size:1em;margin:.2em}
 #status{font-weight:bold}
 canvas{border:1px solid #444;cursor:crosshair;max-width:45vw}
</style></head><body>
<h2>VQ-NeRF material editing</h2>
<div class="row">
 <div>
  <div>view <select id="view"></select>
       overlay <input type="checkbox" id="overlay" checked></div>
  <canvas id="cv"></canvas>
 </div>
 <div>
  <div>segmentation</div><img id="embed">
 </div>
</div>
<div>
 mode <select id="mode"><option>segment</option><option>paint</option>
      <option>erase</option></select>
 brush <input type="range" id="brush" min="1" max="40" value="8"
        style="vertical-align:middle">
 mask <input type="file" id="upload" accept="image/png"
      style="max-width:14em">
</div>
<div>
 material <select id="mat"></select>
 <span id="custom" style="display:none">
  diff <input id="d0" class="b" value="0.8"><input id="d1" class="b"
   value="0.1"><input id="d2" class="b" value="0.1">
  spec <input id="s0" class="b" value="0.04"><input id="s1" class="b"
   value="0.04"><input id="s2" class="b" value="0.04">
  rough <input id="r0" class="b" value="0.4">
 </span>
 illumination <select id="env"></select>
 <button id="submit">apply edit</button>
 <button id="clear">clear selection</button>
 <span id="status">idle</span>
</div>
<style>.b{width:3.2em}</style>
<div class="row" id="results"></div>
<script>
let S={views:[],sel:null,paint:null,drawing:false,painted:false};
const $=id=>document.getElementById(id);
async function j(url,body){const r=await fetch(url,body?{method:'POST',
 body:JSON.stringify(body)}:{});return r.json();}
async function init(){
 const info=await j('/api/views');S.views=info.views;
 $('view').innerHTML=info.views.map(v=>`<option>${v}</option>`).join('');
 $('mat').innerHTML=info.materials.map(m=>`<option>${m}</option>`).join('')
  +'<option>custom</option>';
 $('env').innerHTML=info.envs.map(e=>`<option>${e}</option>`).join('');
 $('view').onchange=()=>{S.paint=null;S.painted=false;draw();};
 $('overlay').onchange=draw;
 $('mat').onchange=()=>{$('custom').style.display=
  $('mat').value=='custom'?'inline':'none';};
 draw();poll();
}
function paintLayer(w,h){
 if(!S.paint){S.paint=document.createElement('canvas');
  S.paint.width=w;S.paint.height=h;}
 return S.paint;
}
function draw(){
 const v=$('view').value,cv=$('cv'),ctx=cv.getContext('2d');
 const img=new Image();
 img.onload=()=>{cv.width=img.width;cv.height=img.height;
  ctx.drawImage(img,0,0);
  if(S.sel&&S.sel.view==v&&$('overlay').checked){
   const ov=new Image();ov.onload=()=>{ctx.globalAlpha=.45;
    ctx.drawImage(ov,0,0);ctx.globalAlpha=1;redrawPaint(ctx);};
   ov.src='data:image/png;base64,'+S.sel.mask_png;}
  else redrawPaint(ctx);}
 img.src=`/view/${v}/pred_rgb.png?${Date.now()}`;
 $('embed').src=`/view/${v}/embed_map.png`;
}
function redrawPaint(ctx){
 if(S.paint){ctx.globalAlpha=.45;ctx.drawImage(S.paint,0,0);
  ctx.globalAlpha=1;}
}
function canvasXY(e){
 const cv=$('cv'),r=cv.getBoundingClientRect();
 return [Math.floor((e.clientX-r.left)*cv.width/r.width),
         Math.floor((e.clientY-r.top)*cv.height/r.height)];
}
function dab(x,y){
 const cv=$('cv'),p=paintLayer(cv.width,cv.height),c=p.getContext('2d');
 c.globalCompositeOperation=
  $('mode').value=='erase'?'destination-out':'source-over';
 c.fillStyle='rgba(255,0,255,1)';
 c.beginPath();c.arc(x,y,+$('brush').value,0,7);c.fill();
 S.painted=true;draw();
}
async function pushMask(){
 if(!S.painted||!S.paint)return;
 const r=await j('/api/mask',{view:+$('view').value,
                              mask_png:S.paint.toDataURL()});
 $('status').textContent=r.error||`painted mask: ${r.count} px`;
}
$('cv').onmousedown=e=>{
 if($('mode').value=='segment')return;
 S.drawing=true;dab(...canvasXY(e));};
$('cv').onmousemove=e=>{if(S.drawing)dab(...canvasXY(e));};
$('cv').onmouseup=()=>{if(S.drawing){S.drawing=false;pushMask();}};
$('cv').onmouseleave=()=>{if(S.drawing){S.drawing=false;pushMask();}};
$('cv').onclick=async e=>{
 if($('mode').value!='segment')return;
 const [x,y]=canvasXY(e);
 $('status').textContent='selecting...';
 S.sel=await j('/api/select',{view:+$('view').value,x:x,y:y});
 S.sel.view=$('view').value;
 $('status').textContent=S.sel.error||
  `segment ${S.sel.embed_id} (${S.sel.count} px)`;
 draw();
};
$('upload').onchange=e=>{
 const f=e.target.files[0];if(!f)return;
 const rd=new FileReader();
 rd.onload=async()=>{
  const r=await j('/api/mask',{view:+$('view').value,mask_png:rd.result});
  $('status').textContent=r.error||`uploaded mask: ${r.count} px`;
  if(!r.error){const img=new Image();img.onload=()=>{
   const p=paintLayer(img.width,img.height);
   p.getContext('2d').drawImage(img,0,0);S.painted=true;draw();};
   img.src=rd.result;}
 };
 rd.readAsDataURL(f);
};
function material(){
 if($('mat').value!='custom')return $('mat').value;
 const g=i=>parseFloat($(i).value);
 return {diff:[g('d0'),g('d1'),g('d2')],
         spec:[g('s0'),g('s1'),g('s2')],rough:[g('r0')]};
}
$('clear').onclick=async()=>{S.sel=null;S.paint=null;S.painted=false;
 await j('/api/clear',{});$('status').textContent='idle';draw();};
$('submit').onclick=async()=>{
 $('status').textContent='submitting...';
 const r=await j('/api/submit',{material:material(),
                                env:$('env').value});
 $('status').textContent=r.error||'uploaded — waiting for server';
};
async function poll(){
 for(;;){
  const st=await j('/api/status');
  if(st.status)$('status').textContent=st.status;
  if(st.status=='finished'){
   $('results').innerHTML=st.results.map(u=>`<img src="${u}?${Date.now()}"
    style="max-width:30vw">`).join('');}
  await new Promise(res=>setTimeout(res,1500));
 }
}
init();
</script></body></html>
"""

_BATCH_RE = re.compile(r"batch(\d{9})$")
_SAFE_IMG = re.compile(r"^[\w.-]+\.png$")


class EditSession:
    """Server-side state: the view list, the segment selection, and any
    hand-painted/uploaded per-view masks (ui4.py:496+ edit surface)."""

    def __init__(self, root, views_dir, envs=("original",)):
        self.root = root
        self.views_dir = views_dir
        self.envs = list(envs)
        self.lock = threading.Lock()
        self.masks = None  # list of [H, W] bool, one per view
        self.painted = {}  # view index -> [H, W] bool (overrides masks)
        self.batches = sorted(
            d for d in os.listdir(views_dir)
            if _BATCH_RE.search(d) and isdir(join(views_dir, d)))
        if not self.batches:
            raise FileNotFoundError(f"no batch%09d dirs under {views_dir}")

    def _embed(self, i):
        p = join(self.views_dir, self.batches[i], "pred_embed.npy")
        if not isfile(p):
            raise FileNotFoundError(
                f"{p} missing: the views directory must be a pd_vq pass "
                "(vis_view saves the raw id map next to embed_map.png)")
        return np.load(p)

    def select(self, view, x, y):
        """Click (x, y) on ``view``: select that embed id across ALL views
        (ui4.py auto_select semantics). Returns a preview for ``view``."""
        emb = self._embed(view)
        h, w = emb.shape[:2]
        if not (0 <= y < h and 0 <= x < w):
            raise ValueError(f"click ({x},{y}) outside {w}x{h}")
        embed_id = int(emb[y, x])
        masks = [auto_select_mask(self._embed(i), embed_id)
                 for i in range(len(self.batches))]
        with self.lock:
            self.masks = masks
        return {
            "embed_id": embed_id,
            "count": int(masks[view].sum()),
            "mask_png": _mask_png_b64(masks[view]),
        }

    def set_mask(self, view, mask):
        """Install a hand-painted/uploaded [H, W] bool mask for ``view``
        (ui4.py manual paint; overrides the segment selection there)."""
        if not (0 <= view < len(self.batches)):
            raise ValueError(f"view {view} out of range")
        emb = self._embed(view)
        if mask.shape != emb.shape[:2]:
            raise ValueError(
                f"mask shape {mask.shape} != view {emb.shape[:2]}")
        with self.lock:
            self.painted[int(view)] = mask.astype(bool)
        return {"count": int(mask.sum())}

    def clear_masks(self):
        with self.lock:
            self.masks = None
            self.painted = {}

    def _final_masks(self):
        """Per-view masks for submit: the painted mask where one exists,
        else the segment selection, else empty."""
        with self.lock:
            masks = list(self.masks) if self.masks is not None else None
            painted = dict(self.painted)
        if masks is None and not painted:
            raise ValueError(
                "no selection — click the render or paint a mask first")
        if masks is None:
            h, w = self._embed(0).shape[:2]
            masks = [np.zeros((h, w), bool)
                     for _ in range(len(self.batches))]
        for i, m in painted.items():
            masks[i] = m
        return masks

    @staticmethod
    def check_material(material):
        """'keep'/db name, or a custom dict of BRDF values (the numeric
        diff/spec/rough entry ui4.py offers; the server protocol already
        accepts arbitrary dicts)."""
        if isinstance(material, str):
            if material not in MATERIAL_DB:
                raise ValueError(f"unknown material {material!r}")
            return material
        if not isinstance(material, dict):
            raise ValueError("material must be a name or a dict")
        out = {}
        for key, n in (("diff", 3), ("spec", 3), ("rough", 1)):
            vals = material.get(key)
            if vals is None:
                raise ValueError(f"custom material missing {key!r}")
            vals = [float(v) for v in np.asarray(vals).reshape(-1)]
            if len(vals) != n:
                raise ValueError(f"{key} needs {n} values, got {vals}")
            # negative first channel = keep-channel (MATERIAL_DB
            # convention); otherwise BRDF values live in [0, 1].
            # NaN must not slip through either branch (NaN >= 0 and
            # NaN <= 1 are both False)
            if not all(np.isfinite(v) for v in vals):
                raise ValueError(f"{key} values must be finite")
            if vals[0] >= 0 and not all(0.0 <= v <= 1.0 for v in vals):
                raise ValueError(f"{key} values must be in [0, 1]")
            out[key] = vals
        return out

    def submit(self, material, env):
        masks = self._final_masks()
        submit_edit(self.root, self.check_material(material), masks,
                    env=env)

    def status(self):
        path = join(self.root, "status", "status.json")
        out = {"status": "idle"}
        if isfile(path):
            with open(path) as f:
                out = json.load(f)
        if out.get("status") == "finished":
            res_root = join(self.root, "pd_edited")
            results = []
            if isdir(res_root):
                for d in sorted(os.listdir(res_root)):
                    m = _BATCH_RE.search(d)
                    if m and isfile(join(res_root, d, "pred_rgb.png")):
                        results.append(
                            f"/result/{int(m.group(1))}/pred_rgb.png")
            out["results"] = results
        return out


def _mask_png_b64(mask):
    """bool [H, W] -> base64 PNG, magenta where selected and transparent
    elsewhere, for the canvas overlay."""
    h, w = mask.shape
    rgba = np.zeros((h, w, 4), np.uint8)
    rgba[mask] = (255, 0, 255, 255)
    return base64.b64encode(vio.encode_png(rgba)).decode("ascii")


def _png_b64_to_mask(b64):
    """base64 PNG (raw or a data: URL) -> [H, W] bool: nonzero alpha where
    the PNG has alpha, else any nonzero channel."""
    img = vio.decode_png(base64.b64decode(b64.split(",")[-1]),
                         what="mask PNG")
    if img.ndim == 2:
        return img > 0
    if img.shape[2] == 4:
        return img[..., -1] > 0
    return img.max(axis=2) > 0


def make_handler(session: EditSession):
    def _file_response(handler, path, ctype="image/png"):
        if not isfile(path):
            handler.send_error(404)
            return
        with open(path, "rb") as f:
            data = f.read()
        handler.send_response(200)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(data)))
        handler.end_headers()
        handler.wfile.write(data)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, obj, code=200):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                data = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/api/views":
                self._json({
                    "views": list(range(len(session.batches))),
                    "materials": list(MATERIAL_DB),
                    "envs": session.envs,
                })
            elif path == "/api/status":
                self._json(session.status())
            else:
                m = re.fullmatch(r"/(view|result)/(\d+)/([\w.-]+)", path)
                if not m or not _SAFE_IMG.fullmatch(m.group(3)):
                    self.send_error(404)
                    return
                i = int(m.group(2))
                if i >= len(session.batches):
                    self.send_error(404)
                    return
                base = (join(session.views_dir, session.batches[i])
                        if m.group(1) == "view"
                        else join(session.root, "pd_edited",
                                  "batch%09d" % i))
                _file_response(self, join(base, m.group(3)))

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/api/select":
                    self._json(session.select(
                        int(body["view"]), int(body["x"]), int(body["y"])))
                elif self.path == "/api/mask":
                    self._json(session.set_mask(
                        int(body["view"]),
                        _png_b64_to_mask(body["mask_png"])))
                elif self.path == "/api/clear":
                    session.clear_masks()
                    self._json({"ok": True})
                elif self.path == "/api/submit":
                    session.submit(body.get("material", "keep"),
                                   body.get("env", "original"))
                    self._json({"ok": True})
                else:
                    self.send_error(404)
            except Exception as e:  # surface errors to the page
                self._json({"error": f"{type(e).__name__}: {e}"}, code=400)

    return Handler


def serve_edit_ui(root, views_dir, port=8008, envs=("original",),
                  serve_forever=True, host="127.0.0.1"):
    """Start the web UI. With serve_forever=False, returns the bound
    ThreadingHTTPServer for the caller to drive.

    Binds loopback by default: POST /api/submit drives file writes and
    the edit server's compute, so remote exposure must be deliberate
    (host="0.0.0.0", the command line's --host)."""
    session = EditSession(root, views_dir, envs=envs)
    httpd = ThreadingHTTPServer((host, port), make_handler(session))
    print(f"edit UI: http://localhost:{httpd.server_address[1]}/ "
          f"({len(session.batches)} views; protocol root {root})")
    if serve_forever:
        httpd.serve_forever()
    return httpd
