"""Interactive 3D ray viewer — self-contained HTML export.

A copy of ``altair_tpu/viz/html.py`` on the port's ``RayPaths`` (numpy and
the standard library only: no matplotlib, so it runs on a machine without
it).

The reference's demo paths open a live ``TGLViewer`` with mouse
rotation/zoom (``makeIntegratingSphere1Ray.C:44-51``,
``visualizeDetector``'s ``Draw("ogl")``).  Without a display
or plotly the equivalent is a single dependency-free HTML file:
the traced paths, sphere wireframe, port circle, detector and source are
embedded as JSON and rendered on a <canvas> with an inline orthographic
projector (drag to rotate, wheel to zoom) — open it in any browser.
"""

from __future__ import annotations

import json

import numpy as np

from ..config import SphereScene
from .rays import RayPaths, _CLASS_COLORS, _detector_curves, _port_circle

_CSS_COLORS = {"green": "#14a02c", "yellow": "#d8b400", "red": "#d62718",
               "gray": "#888888"}

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>altair-tpu ray viewer</title>
<style>
 body{margin:0;background:#10141c;color:#cfd8e3;font:13px sans-serif}
 #hud{position:fixed;top:8px;left:10px;line-height:1.5}
 .sw{display:inline-block;width:10px;height:10px;margin-right:4px}
 canvas{display:block;cursor:grab}
</style></head><body>
<div id="hud"><b>altair-tpu</b> — drag to rotate, wheel to zoom<br>__LEGEND__</div>
<canvas id="c"></canvas>
<script>
const D = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw = -1.0, pitch = 0.35, zoom = 1.0, drag = null;
function resize(){cv.width = innerWidth; cv.height = innerHeight; draw();}
addEventListener('resize', resize);
cv.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => { if(!drag) return;
  yaw += (e.clientX - drag[0]) * 0.008; pitch += (e.clientY - drag[1]) * 0.008;
  pitch = Math.max(-1.55, Math.min(1.55, pitch)); drag = [e.clientX, e.clientY]; draw();});
cv.addEventListener('wheel', e => { e.preventDefault();
  zoom *= Math.exp(-e.deltaY * 0.001); draw();}, {passive:false});
function proj(p){
  const cy = Math.cos(yaw), sy = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x = p[0]*cy + p[1]*sy, y = -p[0]*sy + p[1]*cy;
  const z = p[2]*cp - y*sp;
  const s = Math.min(cv.width, cv.height) / (2.4 * D.scale) * zoom;
  return [cv.width/2 + x*s, cv.height/2 - z*s];
}
function polyline(pts, color, width, alpha){
  ctx.globalAlpha = alpha; ctx.strokeStyle = color; ctx.lineWidth = width;
  ctx.beginPath();
  let q = proj(pts[0]); ctx.moveTo(q[0], q[1]);
  for(let i = 1; i < pts.length; i++){ q = proj(pts[i]); ctx.lineTo(q[0], q[1]); }
  ctx.stroke(); ctx.globalAlpha = 1;
}
function draw(){
  ctx.clearRect(0, 0, cv.width, cv.height);
  for(const w of D.wire) polyline(w, '#2c3a52', 0.7, 0.8);
  polyline(D.port, '#5f8fd0', 1.6, 1);
  if(D.det_sq){ polyline(D.det_sq, '#e8e8e8', 1.4, 1); polyline(D.det_disk, '#28c840', 1.6, 1); }
  for(const r of D.rays) polyline(r.p, r.c, 0.9, 0.75);
  if(D.src){ const q = proj(D.src); ctx.fillStyle = '#ff5060';
    ctx.beginPath(); ctx.arc(q[0], q[1], 5, 0, 6.3); ctx.fill(); }
}
resize();
</script></body></html>
"""


def export_html(paths: RayPaths, scene: SphereScene, save_path: str,
                max_rays: int = 400, only_show_red: bool = False) -> str:
    """Write the interactive viewer to ``save_path``; returns the path."""
    r = float(scene.inner_radius)
    tmax = np.deg2rad(float(scene.theta_max_deg))

    wire = []
    for t in np.linspace(0.25, tmax, 7):          # latitude rings
        ph = np.linspace(0, 2 * np.pi, 49)
        wire.append(np.stack([r * np.sin(t) * np.cos(ph),
                              r * np.sin(t) * np.sin(ph),
                              np.full_like(ph, r * np.cos(t))], 1))
    for p in np.linspace(0, np.pi, 7, endpoint=False):  # meridians
        th = np.linspace(-tmax, tmax, 49)
        wire.append(np.stack([r * np.sin(th) * np.cos(p),
                              r * np.sin(th) * np.sin(p),
                              r * np.cos(th)], 1))

    rays = []
    for i in range(len(paths.classes)):
        cls = str(paths.classes[i])
        if only_show_red and cls != "noexit":
            continue
        if len(rays) >= max_rays:
            break
        k = int(paths.lengths[i])
        pts = paths.points[:k, i]
        rays.append({"p": np.round(pts, 2).tolist(),
                     "c": _CSS_COLORS[_CLASS_COLORS[cls]]})

    data = {
        "scale": float(scene.world_half) * 0.55,
        "wire": [np.round(w, 1).tolist() for w in wire],
        "port": np.round(_port_circle(scene, 49), 1).tolist(),
        "rays": rays,
        "src": list(paths.source) if paths.source else None,
        "det_sq": None,
        "det_disk": None,
    }
    if paths.detector is not None:
        disk, sq = _detector_curves(paths.detector)
        data["det_sq"] = np.round(sq, 2).tolist()
        data["det_disk"] = np.round(disk, 2).tolist()

    legend = "".join(
        f'<span class="sw" style="background:{_CSS_COLORS[c]}"></span>'
        f"{k} ({paths.census[k]})&nbsp;&nbsp;"
        for k, c in _CLASS_COLORS.items())
    html = (_TEMPLATE.replace("__DATA__", json.dumps(data))
            .replace("__LEGEND__", legend))
    with open(save_path, "w") as fh:
        fh.write(html)
    return save_path
