"""Interactive point-cloud views for the attention figures (a copy of
what `uni_adapter_tpu/visualize.py` gives them: `visualize_pointclouds_plotly`,
`scalars_to_viridis_hex`, `visualize_colored_pointcloud_html` and their
helpers), numpy only.

plotly is used when it imports; otherwise the HTML is self-contained: the
points embedded as JSON and drawn by an inline canvas renderer with
mouse-drag rotation and wheel zoom, so the file opens offline.  matplotlib
is imported only where a colour map is needed.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Union

import numpy as np

_COLORS = ["#636efa", "#ef553b", "#00cc96", "#ab63fa", "#ffa15a",
           "#19d3f3", "#ff6692", "#b6e880"]

_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{margin:0;background:#111;color:#eee;font-family:sans-serif}}
#hud{{position:fixed;top:8px;left:12px}}canvas{{display:block}}
.sw{{display:inline-block;width:10px;height:10px;margin-right:4px}}</style>
</head><body>
<div id="hud"><b>{title}</b><br/>{legend}<br/>
<small>drag: rotate &middot; wheel: zoom</small></div>
<canvas id="c"></canvas>
<script>
const CLOUDS = {data};
const COLORS = {colors};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let rx = -1.1, rz = 0.6, zoom = 0.8;
function resize(){{cv.width=innerWidth;cv.height=innerHeight;draw();}}
function draw(){{
  ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
  const s = Math.min(cv.width,cv.height)*0.45*zoom;
  const cx=cv.width/2, cy=cv.height/2;
  const crz=Math.cos(rz),srz=Math.sin(rz),crx=Math.cos(rx),srx=Math.sin(rx);
  CLOUDS.forEach((cl,ci)=>{{
    ctx.fillStyle=COLORS[ci%COLORS.length];
    const p=cl.points;
    for(let i=0;i<p.length;i+=3){{
      const x=p[i],y=p[i+1],z=p[i+2];
      const x1=x*crz-y*srz, y1=x*srz+y*crz;
      const y2=y1*crx-z*srx, z2=y1*srx+z*crx;
      const px=cx+x1*s, py=cy-z2*s;
      const r=Math.max(0.8, 2.2+y2*1.2);
      ctx.globalAlpha={opacity};
      ctx.fillRect(px, py, r, r);
    }}
  }});
  ctx.globalAlpha=1;
}}
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{{drag=true;lx=e.clientX;ly=e.clientY;}};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{{if(!drag)return;rz+=(e.clientX-lx)*0.01;rx+=(e.clientY-ly)*0.01;lx=e.clientX;ly=e.clientY;draw();}};
cv.onwheel=e=>{{zoom*=e.deltaY<0?1.1:0.9;draw();e.preventDefault();}};
window.onresize=resize; resize();
</script></body></html>
"""


def _check_cloud(arr: np.ndarray, name: str) -> np.ndarray:
    # (N,3) xyz, or the repo's xyz‖rgb (N,6) convention (keep xyz); anything
    # else raises — silently dropping a malformed entry would write an empty
    # figure with no error
    if arr.ndim == 2 and arr.shape[1] == 6:
        return arr[:, :3]
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"Point cloud {name} must be (N, 3) or (N, 6); "
                         f"got {arr.shape}.")
    return arr


def _normalize_clouds(pointclouds) -> Dict[str, np.ndarray]:
    if isinstance(pointclouds, np.ndarray):
        return {"Point Cloud": _check_cloud(pointclouds, "")}
    return {k: _check_cloud(np.asarray(v), f"'{k}'")
            for k, v in pointclouds.items()}


def visualize_pointclouds_plotly(pointclouds: Union[dict, np.ndarray],
                                 save_path: Optional[str] = None,
                                 marker_size: int = 3, opacity: float = 0.8,
                                 title: str = "3D Point Cloud Visualization"):
    """Write an interactive HTML view of one or more point clouds.

    Same signature and dict/array input contract as the reference
    (visualization.py:5-47).  Returns the path written (or None)."""
    clouds = _normalize_clouds(pointclouds)
    try:
        import plotly.graph_objects as go

        fig = go.Figure()
        for name, pts in clouds.items():
            fig.add_trace(go.Scatter3d(
                x=pts[:, 0], y=pts[:, 1], z=pts[:, 2], mode="markers",
                marker=dict(size=marker_size, opacity=opacity), name=name))
        fig.update_layout(title=title)
        if save_path:
            if not save_path.lower().endswith(".html"):
                save_path += ".html"
            os.makedirs(os.path.dirname(os.path.abspath(save_path)),
                        exist_ok=True)
            fig.write_html(save_path)
            return save_path
        return None
    except ImportError:
        pass

    # self-contained fallback: embed data + tiny canvas renderer.
    # Normalise JOINTLY (shared center/scale) so overlaid clouds — e.g. a
    # full object plus its top-attention centers — stay spatially aligned,
    # matching both plotly's shared axes and the colored-layer writer below.
    if clouds:
        all_pts = np.concatenate(list(clouds.values()), 0)
        center = all_pts.mean(0, keepdims=True)
        scale = np.abs(all_pts - center).max() + 1e-9
    else:
        center, scale = 0.0, 1.0
    data = []
    for name, pts in clouds.items():
        data.append({"name": name,
                     "points": ((pts - center) / scale)
                     .reshape(-1).round(4).tolist()})
    legend = "<br/>".join(
        f'<span class="sw" style="background:{_COLORS[i % len(_COLORS)]}"></span>{d["name"]}'
        for i, d in enumerate(data))
    html = _HTML_TEMPLATE.format(title=title, data=json.dumps(data),
                                 colors=json.dumps(_COLORS), legend=legend,
                                 opacity=opacity)
    if save_path:
        if not save_path.lower().endswith(".html"):
            save_path += ".html"
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        with open(save_path, "w") as f:
            f.write(html)
        return save_path
    return html


_COLORED_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>body{{margin:0;background:#111;color:#eee;font-family:sans-serif}}
#hud{{position:fixed;top:8px;left:12px}}canvas{{display:block}}</style>
</head><body>
<div id="hud"><b>{title}</b><br/>{legend}<br/>
<small>drag: rotate &middot; wheel: zoom</small></div>
<canvas id="c"></canvas>
<script>
const LAYERS = {data};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let rx = -1.1, rz = 0.6, zoom = 0.8;
function resize(){{cv.width=innerWidth;cv.height=innerHeight;draw();}}
function draw(){{
  ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
  const s = Math.min(cv.width,cv.height)*0.45*zoom;
  const cx=cv.width/2, cy=cv.height/2;
  const crz=Math.cos(rz),srz=Math.sin(rz),crx=Math.cos(rx),srx=Math.sin(rx);
  LAYERS.forEach(L=>{{
    const p=L.points, cols=L.colors, sz=L.size;
    ctx.globalAlpha=L.opacity;
    for(let i=0,j=0;i<p.length;i+=3,j++){{
      const x=p[i],y=p[i+1],z=p[i+2];
      const x1=x*crz-y*srz, y1=x*srz+y*crz;
      const y2=y1*crx-z*srx, z2=y1*srx+z*crx;
      ctx.fillStyle = (typeof cols === 'string') ? cols : cols[j];
      ctx.fillRect(cx+x1*s, cy-z2*s, sz, sz);
    }}
  }});
  ctx.globalAlpha=1;
}}
let drag=false,lx=0,ly=0;
cv.onmousedown=e=>{{drag=true;lx=e.clientX;ly=e.clientY;}};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{{if(!drag)return;rz+=(e.clientX-lx)*0.01;rx+=(e.clientY-ly)*0.01;lx=e.clientX;ly=e.clientY;draw();}};
cv.onwheel=e=>{{zoom*=e.deltaY<0?1.1:0.9;draw();e.preventDefault();}};
window.onresize=resize; resize();
</script></body></html>
"""


def scalars_to_viridis_hex(values: np.ndarray) -> list:
    """Min-max-normalise scalars and map through viridis to hex strings."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import cm, colors as mcolors

    v = np.asarray(values, np.float64)
    v = (v - v.min()) / (v.max() - v.min() + 1e-12)
    return [mcolors.to_hex(c) for c in cm.viridis(v)]


def visualize_colored_pointcloud_html(layers, save_path: str,
                                      title: str = "Point Cloud"):
    """Self-contained interactive HTML with PER-POINT colours.

    The role of the reference's plotly scalar-coloured Scatter3d overlays
    (extract_attention.py:762-935) in this plotly-free environment: data is
    embedded as JSON, rendered by an inline canvas with drag-rotate / zoom.

    Args:
      layers: list of dicts {"name", "points" (N,3), "colors": hex string OR
        (N,) scalar array (mapped through viridis), "size", "opacity"}.
    Returns the path written.
    """
    data = []
    all_pts = np.concatenate([np.asarray(l["points"]) for l in layers], 0)
    center = all_pts.mean(0, keepdims=True)
    scale = np.abs(all_pts - center).max() + 1e-9
    legend_bits = []
    for l in layers:
        pts = (np.asarray(l["points"]) - center) / scale
        colors = l.get("colors", "#aaaaaa")
        if not isinstance(colors, str):
            colors = scalars_to_viridis_hex(colors)
        data.append({"name": l["name"],
                     "points": pts.reshape(-1).round(4).tolist(),
                     "colors": colors,
                     "size": float(l.get("size", 2.5)),
                     "opacity": float(l.get("opacity", 0.9))})
        swatch = colors if isinstance(colors, str) else "#26828e"
        legend_bits.append(
            f'<span style="color:{swatch}">&#9632;</span> {l["name"]}')
    html = _COLORED_TEMPLATE.format(title=title, data=json.dumps(data),
                                    legend="<br/>".join(legend_bits))
    if not save_path.lower().endswith(".html"):
        save_path += ".html"
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    with open(save_path, "w") as f:
        f.write(html)
    return save_path
