"""Mesh file I/O: the port's own copy of ``meshfem_tpu/io/meshio.py``
(host numpy, no device work), writing the same bytes and reading the same
files.

Parity with reference ``MeshIO.hh/.cc`` (``MeshIO.hh:33-38``): OFF, OBJ,
Gmsh MSH v2.2 (ASCII + binary, little-endian, with optional field
sections), MEDIT (.mesh), STL (ASCII + binary), Triangle .node/.ele and
.poly; format guessed from the extension (``guessFormat``,
``MeshIO.hh:329``).

Loads return ``(V [n, 3] float64, F [m, k] int64)`` vertex/element soups
(elements may be mixed-degree in MSH: P2 tri6/tet10 nodes are returned in
GMSH ordering, matching ``Simplex.hh:31-46``).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_MSH_TYPE = {1: 2, 2: 3, 4: 4, 8: 3, 9: 6, 11: 10, 15: 1}
_MSH_TYPE_FOR_NODES = {(1, 2): 1, (2, 3): 2, (3, 4): 4,
                       (1, 3): 8, (2, 6): 9, (3, 10): 11}


def guess_format(path) -> str:
    ext = Path(path).suffix.lower().lstrip(".")
    if ext in ("off", "obj", "msh", "stl", "mesh", "poly", "node", "ele"):
        return "medit" if ext == "mesh" else ext
    raise ValueError(f"cannot guess mesh format for {path!r}")


def load(path, format: str | None = None):
    fmt = format or guess_format(path)
    return {
        "off": load_off, "obj": load_obj, "msh": load_msh,
        "stl": load_stl, "medit": load_medit, "node": load_node_ele,
        "ele": load_node_ele, "poly": load_poly,
    }[fmt](path)


def save(path, V, F, format: str | None = None) -> None:
    fmt = format or guess_format(path)
    {
        "off": save_off, "obj": save_obj, "msh": save_msh,
        "stl": save_stl, "medit": save_medit, "node": save_node_ele,
    }[fmt](path, V, F)


def numbered_rows(fmt, rows, prefix="") -> str:
    """The text lines ``"<k> <prefix> <row k>"``, k from 1, each value
    formatted by the %-format ``fmt`` (``"%.17g" % x`` is the same text as
    ``f"{x:.17g}"``)."""
    rows = np.asarray(rows)
    line = "%d" + prefix + (" " + fmt) * rows.shape[1] + "\n"
    return "".join(map(line.__mod__, zip(range(1, len(rows) + 1),
                                         *rows.T.tolist())))


def _pad3(V):
    V = np.atleast_2d(np.asarray(V, dtype=np.float64))
    if V.shape[1] < 3:
        V = np.pad(V, [(0, 0), (0, 3 - V.shape[1])])
    return V


# -- OFF --------------------------------------------------------------------

def load_off(path):
    tok = _token_stream(path)
    magic = next(tok)
    if magic.upper() not in ("OFF", "COFF", "NOFF"):
        raise ValueError(f"not an OFF file: {path}")
    nv, nf, _ = int(next(tok)), int(next(tok)), int(next(tok))
    V = np.array([[float(next(tok)) for _ in range(3)] for _ in range(nv)])
    F = []
    for _ in range(nf):
        k = int(next(tok))
        F.append([int(next(tok)) for _ in range(k)])
    return V, np.asarray(F, dtype=np.int64)


def save_off(path, V, F) -> None:
    V = _pad3(V)
    F = np.asarray(F)
    with open(path, "w") as f:
        f.write(f"OFF\n{len(V)} {len(F)} 0\n")
        for v in V:
            f.write(f"{v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
        for e in F:
            f.write(f"{len(e)} " + " ".join(map(str, e)) + "\n")


# -- OBJ --------------------------------------------------------------------

def load_obj(path):
    V, F = [], []
    for line in open(path):
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            V.append([float(x) for x in parts[1:4]])
        elif parts[0] == "f":
            idx = [int(p.split("/")[0]) for p in parts[1:]]
            F.append([i - 1 if i > 0 else len(V) + i for i in idx])
    lens = {len(f) for f in F}
    if len(lens) == 1:
        F = np.asarray(F, dtype=np.int64)
    return np.asarray(V, dtype=np.float64), F


def save_obj(path, V, F) -> None:
    V = _pad3(V)
    with open(path, "w") as f:
        for v in V:
            f.write(f"v {v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
        for e in np.asarray(F):
            f.write("f " + " ".join(str(i + 1) for i in e) + "\n")


# -- MSH v2.2 (ASCII + binary) ---------------------------------------------

def load_msh(path):
    with open(path, "rb") as f:
        data = f.read()
    # Parse $MeshFormat
    head_end = data.find(b"$EndMeshFormat")
    header = data[:head_end].split()
    version, is_binary = header[1].decode(), int(header[2])
    if not version.startswith("2"):
        raise ValueError(f"only MSH v2.x supported, got {version}")
    if is_binary:
        return _load_msh_binary(data)
    return _load_msh_ascii(data.decode())


def _tokens(lines, k):
    """The first k whitespace-separated tokens of each line, in one flat
    list (one split of the whole block when every line has exactly k
    tokens, else line by line)."""
    tok = " ".join(lines).split()
    if len(tok) != k * len(lines):
        tok = [t for line in lines for t in line.split()[:k]]
    return tok


def _parse(tok, conv=float, dtype=np.float64):
    return np.fromiter(map(conv, tok), dtype, count=len(tok))


def parse_table(lines, k, conv=float, dtype=np.float64):
    """``_tokens(lines, k)`` converted by ``conv``: [len(lines), k]."""
    return _parse(_tokens(lines, k), conv, dtype).reshape(len(lines), k)


def _load_msh_ascii(text):
    lines = text.splitlines()
    V, ids, elems = None, None, []
    i = 0
    while i < len(lines):
        s = lines[i].strip()
        i += 1
        if s == "$Nodes":
            n = int(lines[i])
            tok = _tokens(lines[i + 1:i + 1 + n], 4)
            ids = _parse(tok[0::4], int, np.int64)
            V = np.stack([_parse(tok[c::4]) for c in (1, 2, 3)], axis=1)
            i += 1 + n
        elif s == "$Elements":
            m = int(lines[i])
            block = lines[i + 1:i + 1 + m]
            i += 1 + m
            tok = " ".join(block).split()
            width = len(block[0].split()) if m else 0
            if m and len(tok) == width * m:
                # the same token count on every line: one array, kept if
                # every element has one type and tag count
                a = _parse(tok, int, np.int64).reshape(m, width)
                if (a[:, 1] == a[0, 1]).all() and (a[:, 2] == a[0, 2]).all():
                    elems.append((int(a[0, 1]), a[:, 3 + a[0, 2]:]))
                    continue
            for line in block:
                parts = line.split()
                ntags = int(parts[2])
                elems.append((int(parts[1]), np.asarray(
                    [[int(x) for x in parts[3 + ntags:]]], dtype=np.int64)))
    return _finish_msh(V, ids, elems)


def _load_msh_binary(data):
    # Verify the endianness marker: the int 1 written right after the
    # "2.2 1 8" header line (format spec; written by save_msh below).
    hdr = data.find(b"$MeshFormat")
    marker_pos = data.find(b"\n", data.find(b"\n", hdr) + 1) + 1
    (marker,) = struct.unpack_from("<i", data, marker_pos)
    if marker != 1:
        raise ValueError(
            f"binary MSH endianness marker is {marker}, expected 1 "
            "(big-endian files are not supported)")
    nodes_pos = data.find(b"$Nodes")
    p = data.find(b"\n", nodes_pos) + 1
    nl = data.find(b"\n", p)
    n = int(data[p:nl])
    p = nl + 1
    rec = np.frombuffer(data, dtype=np.uint8, count=n * (4 + 24),
                        offset=p).reshape(n, 28)
    ids = rec[:, :4].copy().view("<i4").ravel().astype(np.int64)
    V = rec[:, 4:].copy().view("<f8").reshape(n, 3).astype(np.float64)
    p += n * 28
    elems = []
    ep = data.find(b"$Elements", p)
    p = data.find(b"\n", ep) + 1
    nl = data.find(b"\n", p)
    m = int(data[p:nl])
    p = nl + 1
    read = 0
    while read < m:
        etype, nelems, ntags = struct.unpack_from("<iii", data, p)
        p += 12
        nn = _MSH_TYPE[etype]
        block = np.frombuffer(data, dtype="<i4", count=nelems
                              * (1 + ntags + nn), offset=p)
        block = block.reshape(nelems, 1 + ntags + nn)
        elems.append((etype, block[:, 1 + ntags:].astype(np.int64)))
        p += nelems * 4 * (1 + ntags + nn)
        read += nelems
    return _finish_msh(V, ids, elems)


def _finish_msh(V, ids, elems):
    """Keep the highest-dimension element blocks ``(etype, [count, nn]
    node ids)`` and map their node ids to row indices of V."""
    dim_of = {1: 0, 2: 1, 8: 1, 3: 2, 9: 2, 4: 3, 11: 3, 15: 0}
    best = max((dim_of[t] for t, _ in elems), default=0)
    blocks = [ns for t, ns in elems if dim_of[t] == best]
    if len({b.shape[1] for b in blocks}) != 1:
        raise ValueError("mixed element types in MSH")
    raw = np.concatenate(blocks)
    order = np.argsort(ids, kind="stable")
    pos = np.searchsorted(ids[order], raw).clip(max=len(ids) - 1)
    missing = ids[order][pos] != raw
    if missing.any():
        raise KeyError(int(raw[missing][0]))
    return V, order[pos].astype(np.int64)


def save_msh(path, V, F, binary: bool = False, fields=None) -> None:
    """Write MSH v2.2.  F with 3/6 columns -> tri3/tri6, 4/10 -> tet4/tet10.
    ``fields``: optional list of field dicts (see msh_fields.write_fields)."""
    V = _pad3(V)
    F = np.asarray(F)
    nn = F.shape[1]
    dim = {3: 2, 6: 2, 4: 3, 10: 3}[nn]
    etype = _MSH_TYPE_FOR_NODES[(dim, nn)]
    if binary:
        with open(path, "wb") as f:
            f.write(b"$MeshFormat\n2.2 1 8\n")
            f.write(struct.pack("<i", 1))
            f.write(b"\n$EndMeshFormat\n$Nodes\n")
            f.write(str(len(V)).encode() + b"\n")
            rec = np.empty((len(V), 28), dtype=np.uint8)
            ids = np.arange(1, len(V) + 1, dtype=np.int32)
            rec[:, :4] = ids.view(np.uint8).reshape(-1, 4)
            rec[:, 4:] = V.astype("<f8").view(np.uint8).reshape(-1, 24)
            f.write(rec.tobytes())
            f.write(b"\n$Elements\n" + str(len(F)).encode() + b"\n")
            f.write(struct.pack("<iii", etype, len(F), 2))
            blk = np.empty((len(F), 3 + nn), dtype=np.int32)
            blk[:, 0] = np.arange(1, len(F) + 1)
            blk[:, 1] = 0
            blk[:, 2] = 0
            blk[:, 3:] = F + 1
            f.write(blk.astype("<i4").tobytes())
            f.write(b"\n$EndElements\n")
    else:
        with open(path, "w") as f:
            f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
            f.write(f"$Nodes\n{len(V)}\n")
            f.write(numbered_rows("%.17g", V))
            f.write(f"$EndNodes\n$Elements\n{len(F)}\n")
            f.write(numbered_rows("%d", F + 1, f" {etype} 2 0 0"))
            f.write("$EndElements\n")
    if fields:
        from .msh_fields import append_fields

        append_fields(path, fields)


# -- MEDIT ------------------------------------------------------------------

def load_medit(path):
    tok = _token_stream(path)
    V, tris, tets = None, [], []
    for t in tok:
        key = t.lower()
        if key == "dimension":
            next(tok)
        elif key == "vertices":
            n = int(next(tok))
            V = np.empty((n, 3))
            for i in range(n):
                V[i] = [float(next(tok)), float(next(tok)),
                        float(next(tok))]
                next(tok)  # ref
        elif key == "triangles":
            n = int(next(tok))
            for _ in range(n):
                tris.append([int(next(tok)) - 1 for _ in range(3)])
                next(tok)
        elif key == "tetrahedra":
            n = int(next(tok))
            for _ in range(n):
                tets.append([int(next(tok)) - 1 for _ in range(4)])
                next(tok)
        elif key == "end":
            break
    F = np.asarray(tets if tets else tris, dtype=np.int64)
    return V, F


def save_medit(path, V, F) -> None:
    V = _pad3(V)
    F = np.asarray(F)
    name = "Tetrahedra" if F.shape[1] == 4 else "Triangles"
    with open(path, "w") as f:
        f.write("MeshVersionFormatted 1\nDimension\n3\n")
        f.write(f"Vertices\n{len(V)}\n")
        for v in V:
            f.write(f"{v[0]:.17g} {v[1]:.17g} {v[2]:.17g} 0\n")
        f.write(f"{name}\n{len(F)}\n")
        for e in F:
            f.write(" ".join(str(i + 1) for i in e) + " 0\n")
        f.write("End\n")


# -- STL --------------------------------------------------------------------

def load_stl(path, merge_eps: float = 0.0):
    data = open(path, "rb").read()
    if data[:5].lower() == b"solid" and b"facet" in data[:200]:
        tris = []
        cur = []
        for line in data.decode().splitlines():
            parts = line.split()
            if parts[:1] == ["vertex"]:
                cur.append([float(x) for x in parts[1:4]])
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
        tri = np.asarray(tris)
    else:
        (n,) = struct.unpack_from("<I", data, 80)
        rec = np.frombuffer(data, dtype=np.uint8, count=n * 50, offset=84)
        rec = rec.reshape(n, 50)
        vals = rec[:, :48].copy().view("<f4").reshape(n, 4, 3)
        tri = vals[:, 1:, :].astype(np.float64)
    # Merge duplicate vertices: quantize by merge_eps when given, else by
    # near-exact 12-decimal rounding.
    flat = tri.reshape(-1, 3)
    if merge_eps > 0:
        key = np.round(flat / merge_eps).astype(np.int64)
        _, first, inverse = np.unique(key, axis=0, return_index=True,
                                      return_inverse=True)
        uniq = flat[first]
    else:
        uniq, inverse = np.unique(flat.round(decimals=12), axis=0,
                                  return_inverse=True)
    F = inverse.reshape(-1, 3).astype(np.int64)
    return uniq, F


def save_stl(path, V, F, binary: bool = True) -> None:
    V = _pad3(V)
    F = np.asarray(F)
    tri = V[F]
    n1 = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm = n1 / np.maximum(np.linalg.norm(n1, axis=1, keepdims=True), 1e-300)
    if binary:
        with open(path, "wb") as f:
            f.write(b"\0" * 80)
            f.write(struct.pack("<I", len(F)))
            rec = np.zeros((len(F), 50), dtype=np.uint8)
            vals = np.ascontiguousarray(np.concatenate(
                [nrm[:, None, :], tri], axis=1).astype("<f4"))
            rec[:, :48] = vals.reshape(len(F), 12).view(np.uint8)
            f.write(rec.tobytes())
    else:
        with open(path, "w") as f:
            f.write("solid mesh\n")
            for nv, t in zip(nrm, tri):
                f.write(f" facet normal {nv[0]} {nv[1]} {nv[2]}\n"
                        "  outer loop\n")
                for v in t:
                    f.write(f"   vertex {v[0]} {v[1]} {v[2]}\n")
                f.write("  endloop\n endfacet\n")
            f.write("endsolid mesh\n")


# -- Triangle .node/.ele / .poly -------------------------------------------

def load_node_ele(path):
    base = Path(path).with_suffix("")
    ntok = _token_stream(base.with_suffix(".node"))
    nv, dim, nattr, nbm = (int(next(ntok)) for _ in range(4))
    V = np.empty((nv, dim))
    first_idx = None
    for i in range(nv):
        idx = int(next(ntok))
        if first_idx is None:
            first_idx = idx
        V[i] = [float(next(ntok)) for _ in range(dim)]
        for _ in range(nattr + nbm):
            next(ntok)
    etok = _token_stream(base.with_suffix(".ele"))
    ne, npe, nattr = (int(next(etok)) for _ in range(3))
    F = np.empty((ne, npe), dtype=np.int64)
    for i in range(ne):
        next(etok)
        F[i] = [int(next(etok)) - first_idx for _ in range(npe)]
        for _ in range(nattr):
            next(etok)
    return V, F


def save_node_ele(path, V, F) -> None:
    base = Path(path).with_suffix("")
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F)
    with open(base.with_suffix(".node"), "w") as f:
        f.write(f"{len(V)} {V.shape[1]} 0 0\n")
        for i, v in enumerate(V):
            f.write(f"{i+1} " + " ".join(f"{x:.17g}" for x in v) + "\n")
    with open(base.with_suffix(".ele"), "w") as f:
        f.write(f"{len(F)} {F.shape[1]} 0\n")
        for i, e in enumerate(F):
            f.write(f"{i+1} " + " ".join(str(j + 1) for j in e) + "\n")


def load_poly(path):
    """PSLG .poly: returns (points [n, 2], segments [m, 2], holes [h, 2])."""
    tok = _token_stream(path)
    nv, dim, nattr, nbm = (int(next(tok)) for _ in range(4))
    V = np.empty((nv, dim))
    first = None
    for i in range(nv):
        idx = int(next(tok))
        first = idx if first is None else first
        V[i] = [float(next(tok)) for _ in range(dim)]
        for _ in range(nattr + nbm):
            next(tok)
    ns, nbm2 = int(next(tok)), int(next(tok))
    S = np.empty((ns, 2), dtype=np.int64)
    for i in range(ns):
        next(tok)
        S[i] = [int(next(tok)) - first, int(next(tok)) - first]
        for _ in range(nbm2):
            next(tok)
    nh = int(next(tok))
    H = np.empty((nh, 2))
    for i in range(nh):
        next(tok)
        H[i] = [float(next(tok)), float(next(tok))]
    return V, S, H


def _token_stream(path):
    for line in open(path):
        line = line.split("#", 1)[0]
        for t in line.split():
            yield t
