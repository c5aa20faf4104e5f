"""Visualization (counterpart of ``meshfem_tpu/vis.py``; the reference's
Jupyter viewer stack, ``python/tri_mesh_viewer.py`` / ``python/vis``):
matplotlib rendering of 2D and 3D meshes and fields, the triangle soup the
reference's bindings expose (``mesh.cc:76-81``), eigenmode frames and a
self-contained WebGL viewer written with the reference's HTML template.

Host numpy and matplotlib; tensors (on the card or not) are read to the
host.  Nodal fields are read at the vertices through ``vertex_nodes``, so
any ``node_order`` renders.  A per-element field on a tet mesh (one value
per boundary triangle) is normalised with ``np.ptp``: the reference calls
the ``ndarray.ptp`` method, which NumPy 2 removed, and raises there.
"""

from __future__ import annotations

import json

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _vertex_rows(mesh, a) -> np.ndarray:
    """The vertex rows of a per-node array (or the first rows of a
    per-vertex one)."""
    a = _host(a)
    if len(a) == mesh.num_nodes:
        return a[mesh.vertex_nodes]
    return a[:mesh.num_vertices]


def visualization_geometry(mesh):
    """(V, F, N) triangle soup for rendering: 2D/3D triangle meshes render
    directly; tet meshes render their boundary surface."""
    if mesh.K == 2:
        V = mesh.V if mesh.dim == 3 else np.pad(mesh.V, [(0, 0), (0, 1)])
        F = mesh.F
    else:
        V = mesh.V
        F = mesh.bdry_elems
    tri = V[F]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)
    return V, F, n


def plot_mesh(mesh, field=None, *, ax=None, deformation=None, scale=1.0,
              cmap="viridis", show_edges=True):
    """Render a mesh with an optional nodal or per-element scalar field.
    Returns the matplotlib axes (the caller saves the figure)."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    import matplotlib.tri as mtri

    V = mesh.V.copy()
    if deformation is not None:
        V = V + scale * _vertex_rows(mesh, deformation)[:, :V.shape[1]]
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    if mesh.K == 2 and mesh.dim == 2:
        triang = mtri.Triangulation(V[:, 0], V[:, 1], mesh.F)
        if field is not None:
            f = _host(field)
            if len(f) == mesh.num_nodes:
                tpc = ax.tripcolor(triang, _vertex_rows(mesh, f),
                                   shading="gouraud", cmap=cmap)
            else:
                tpc = ax.tripcolor(triang, facecolors=f, cmap=cmap)
            plt.colorbar(tpc, ax=ax, shrink=0.8)
        if show_edges:
            ax.triplot(triang, lw=0.3, color="k", alpha=0.4)
        ax.set_aspect("equal")
    else:
        # 3D: the boundary triangles as shaded polygons
        from mpl_toolkits.mplot3d.art3d import Poly3DCollection

        fig = ax.figure
        ax.remove()
        ax = fig.add_subplot(projection="3d")
        Vv, F, n = visualization_geometry(mesh)
        Vd = Vv.copy()
        if deformation is not None:
            Vd = Vd + scale * _vertex_rows(mesh, deformation)
        shade = 0.4 + 0.6 * np.abs(n @ np.array([0.3, 0.5, 0.8]))
        pc = Poly3DCollection(Vd[F], edgecolor="k", linewidths=0.2)
        if field is not None and len(_host(field)) == len(F):
            f = _host(field).astype(float)
            f = (f - f.min()) / max(np.ptp(f), 1e-30)
            pc.set_facecolor(matplotlib.colormaps[cmap](f))
        else:
            pc.set_facecolor(np.outer(shade, [0.6, 0.7, 0.9]))
        ax.add_collection3d(pc)
        lo, hi = Vd.min(0), Vd.max(0)
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
    return ax


def save_mesh_png(path, mesh, field=None, **kw):
    import matplotlib.pyplot as plt

    ax = plot_mesh(mesh, field, **kw)
    ax.figure.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(ax.figure)


def mode_animation_frames(mesh, mode, n_frames: int = 16, scale=0.1):
    """Displacement snapshots for eigenmode animation
    (``python/mode_viewer.py``)."""
    mode = _host(mode)
    amp = scale / max(np.abs(mode).max(), 1e-30)
    return [amp * np.sin(2 * np.pi * t / n_frames) * mode
            for t in range(n_frames)]


def write_html_viewer(path, mesh, field=None, deformation=None,
                      mode=None, n_frames: int = 24, scale: float = 0.1,
                      title: str = "meshfem_tpu_torch viewer"):
    """Self-contained interactive WebGL viewer (no external dependencies;
    in place of the reference's pythreejs ``TriMeshViewer`` /
    ``mode_viewer``): orbit and zoom, a per-vertex scalar colormap, and a
    static displacement or an animated eigenmode.

    field: [N] or [E] scalars; deformation: [N, dim] static displacement;
    mode: [N, dim] eigenmode (animated over ``n_frames`` sine phases).
    Given the reference's arguments, the file is the reference's byte for
    byte."""
    V, F, _ = visualization_geometry(mesh)
    V = np.asarray(V, dtype=np.float64)
    if V.shape[1] == 2:
        V = np.hstack([V, np.zeros((len(V), 1))])
    F = np.asarray(F)

    col = None
    if field is not None:
        f = _host(field).astype(float)
        if len(f) == len(F):                      # per element -> per vertex
            acc = np.zeros(len(V))
            cnt = np.zeros(len(V))
            for c in range(F.shape[1]):
                np.add.at(acc, F[:, c], f)
                np.add.at(cnt, F[:, c], 1.0)
            f = acc / np.maximum(cnt, 1)
        lo, hi = float(f.min()), float(f.max())
        t = (f - lo) / max(hi - lo, 1e-30)
        # viridis-like 3-stop ramp
        col = np.stack([
            0.267 + (0.993 - 0.267) * t,
            0.005 + 0.9 * t,
            0.329 + (1 - t) * 0.4], axis=1)
        col = np.clip(col, 0, 1)

    frames = None
    if mode is not None:
        m = _host(mode).astype(float)
        if m.shape[1] == 2:
            m = np.hstack([m, np.zeros((len(m), 1))])
        amp = scale * float(np.linalg.norm(V.max(0) - V.min(0))) \
            / max(np.abs(m).max(), 1e-30)
        frames = [(V + amp * np.sin(2 * np.pi * k / n_frames) * m).tolist()
                  for k in range(n_frames)]
    elif deformation is not None:
        d = _host(deformation).astype(float)
        if d.shape[1] == 2:
            d = np.hstack([d, np.zeros((len(d), 1))])
        V = V + d

    data = {
        "V": V.tolist(),
        "F": F.tolist(),
        "C": col.tolist() if col is not None else None,
        "frames": frames,
    }
    html = _VIEWER_HTML.replace("__TITLE__", title).replace(
        "__DATA__", json.dumps(data))
    with open(path, "w") as fh:
        fh.write(html)
    return path


_VIEWER_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>body{margin:0;background:#111;color:#ddd;font-family:sans-serif}
#hud{position:fixed;top:8px;left:10px;font-size:12px}</style></head>
<body><div id="hud">__TITLE__ — drag to orbit, wheel to zoom</div>
<canvas id="c"></canvas>
<script>
const DATA=__DATA__;
const cv=document.getElementById('c');const gl=cv.getContext('webgl');
function fit(){cv.width=innerWidth;cv.height=innerHeight;
gl.viewport(0,0,cv.width,cv.height);}addEventListener('resize',fit);fit();
const VS=`attribute vec3 p;attribute vec3 col;uniform mat4 mvp;
varying vec3 vc;void main(){gl_Position=mvp*vec4(p,1.0);vc=col;}`;
const FS=`precision mediump float;varying vec3 vc;
void main(){gl_FragColor=vec4(vc,1.0);}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);
gl.compileShader(o);return o;}
const pr=gl.createProgram();gl.attachShader(pr,sh(gl.VERTEX_SHADER,VS));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,FS));gl.linkProgram(pr);
gl.useProgram(pr);gl.enable(gl.DEPTH_TEST);
const V=DATA.V,F=DATA.F,C=DATA.C;
// center/scale
let lo=[1e30,1e30,1e30],hi=[-1e30,-1e30,-1e30];
for(const v of V)for(let k=0;k<3;k++){lo[k]=Math.min(lo[k],v[k]);
hi[k]=Math.max(hi[k],v[k]);}
const ctr=[0,1,2].map(k=>(lo[k]+hi[k])/2);
const rad=Math.max(hi[0]-lo[0],hi[1]-lo[1],hi[2]-lo[2])||1;
// triangles (surface faces for tets handled upstream) + flat arrays
function flatten(verts){const pos=[],col=[];
for(const f of F){for(const vi of f.slice(0,3)){
const v=verts[vi];pos.push((v[0]-ctr[0])/rad,(v[1]-ctr[1])/rad,
(v[2]-ctr[2])/rad);
const c=C?C[vi]:[0.55,0.65,0.85];col.push(c[0],c[1],c[2]);}}
return {pos:new Float32Array(pos),col:new Float32Array(col)};}
const pb=gl.createBuffer(),cb=gl.createBuffer();
const la=gl.getAttribLocation(pr,'p'),lc=gl.getAttribLocation(pr,'col');
function upload(verts){const d=flatten(verts);
gl.bindBuffer(gl.ARRAY_BUFFER,pb);
gl.bufferData(gl.ARRAY_BUFFER,d.pos,gl.DYNAMIC_DRAW);
gl.enableVertexAttribArray(la);gl.vertexAttribPointer(la,3,gl.FLOAT,false,0,0);
gl.bindBuffer(gl.ARRAY_BUFFER,cb);
gl.bufferData(gl.ARRAY_BUFFER,d.col,gl.DYNAMIC_DRAW);
gl.enableVertexAttribArray(lc);gl.vertexAttribPointer(lc,3,gl.FLOAT,false,0,0);
return d.pos.length/3;}
let nv=upload(V);
let rx=-0.6,ry=0.7,dist=2.6,drag=false,px=0,py=0;
cv.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;};
onmouseup=()=>drag=false;
onmousemove=e=>{if(!drag)return;ry+=(e.clientX-px)*0.01;
rx+=(e.clientY-py)*0.01;px=e.clientX;py=e.clientY;};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();};
function mat(){const a=Math.cos(rx),b=Math.sin(rx),c=Math.cos(ry),
d=Math.sin(ry);const f=cv.width/cv.height,n=0.01,fa=100,fov=1.2;
const t=1/Math.tan(fov/2);
// model-view: rotY then rotX then translate -dist
const mv=[c,d*b,-d*a,0, 0,a,b,0, d,-c*b,c*a,0, 0,0,-dist,1];
const pm=[t/f,0,0,0, 0,t,0,0, 0,0,(fa+n)/(n-fa),-1, 0,0,2*fa*n/(n-fa),0];
// mvp = pm * mv
const o=new Float32Array(16);
for(let i=0;i<4;i++)for(let j=0;j<4;j++){let s=0;
for(let k=0;k<4;k++)s+=pm[k*4+j]*mv[i*4+k];o[i*4+j]=s;}return o;}
const lm=gl.getUniformLocation(pr,'mvp');
let fi=0;
function draw(){if(DATA.frames){nv=upload(DATA.frames[fi%DATA.frames.length]);
fi++;}
gl.clearColor(0.07,0.07,0.08,1);
gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
gl.uniformMatrix4fv(lm,false,mat());gl.drawArrays(gl.TRIANGLES,0,nv);
requestAnimationFrame(draw);}draw();
</script></body></html>
"""
