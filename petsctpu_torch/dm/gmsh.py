"""Gmsh mesh-file ingestion -> Plex (+ physical-group labels).

Counterpart of petsctpu/dm/gmsh.py: host parsing, as there.

Reference: DMPlexCreateGmsh / DMPlexCreateFromFile
(src/dm/impls/plex/plexcreate.c and the Gmsh reader the reference's
Plex grew for unstructured workflows): parse the MSH 2.2 ASCII
format ($MeshFormat/$PhysicalNames/$Nodes/$Elements), build the cell
list of the highest-dimensional element block, and turn physical
tags into labels — "Cell Sets" for cell regions and "Face Sets" for
boundary facets (the names the reference's reader uses), plus each
named physical group as its own label.
"""

from __future__ import annotations

import numpy as np

# MSH element type -> (nodes, dim)
_ELEM = {
    1: (2, 1),    # 2-node line
    2: (3, 2),    # 3-node triangle
    3: (4, 2),    # 4-node quad
    4: (4, 3),    # 4-node tet
    5: (8, 3),    # 8-node hex
    15: (1, 0),   # point
}


def _is_binary_msh(raw: bytes) -> bool:
    head = raw[:200].split(b"\n")
    return (len(head) > 1 and head[0].strip() == b"$MeshFormat"
            and head[1].split()[1:2] == [b"1"])


def _binary_msh_to_ascii(raw: bytes) -> str:
    """Convert MSH 2.2 BINARY to the equivalent ASCII text (then the
    ordinary parser runs). Format: ASCII section markers; $Nodes =
    nn records of (int32 id, 3 float64); $Elements = blocks of
    (int32 etype, int32 nelems, int32 ntags) + nelems records of
    (int32 id, ntags int32 tags, nnodes int32 nodes); endianness from
    the int32(1) probe in $MeshFormat."""
    import struct

    def line_end(pos):
        e = raw.index(b"\n", pos)
        return raw[pos:e].decode(), e + 1

    p = raw.index(b"$MeshFormat")
    _, p = line_end(p)
    fmt, p = line_end(p)
    ver, ftype, dsize = fmt.split()
    probe = struct.unpack("<i", raw[p:p + 4])[0]
    endian = "<" if probe == 1 else ">"
    out = ["$MeshFormat", f"{ver} 0 {dsize}", "$EndMeshFormat"]

    q = raw.find(b"$PhysicalNames")
    if q >= 0:
        e = raw.index(b"$EndPhysicalNames")
        out.append(raw[q:e + len(b"$EndPhysicalNames")].decode())

    q = raw.index(b"$Nodes")
    _, q = line_end(q)
    nnline, q = line_end(q)
    nn = int(nnline)
    out += ["$Nodes", str(nn)]
    rec = struct.Struct(endian + "i3d")
    for k in range(nn):
        nid, x, y, z = rec.unpack_from(raw, q + k * rec.size)
        out.append(f"{nid} {x:.17g} {y:.17g} {z:.17g}")
    q += nn * rec.size
    out.append("$EndNodes")

    q = raw.index(b"$Elements", q)
    _, q = line_end(q)
    neline, q = line_end(q)
    ne = int(neline)
    out += ["$Elements", str(ne)]
    ii = struct.Struct(endian + "i")
    done = 0
    while done < ne:
        etype, nel, ntags = struct.unpack_from(endian + "3i", raw, q)
        q += 12
        if etype not in _ELEM:
            raise ValueError(f"gmsh: unsupported element type {etype}")
        nnod = _ELEM[etype][0]
        per = 1 + ntags + nnod
        for k in range(nel):
            vals = struct.unpack_from(endian + f"{per}i", raw, q)
            q += 4 * per
            eid, tags, nodes = vals[0], vals[1:1 + ntags], \
                vals[1 + ntags:]
            out.append(" ".join(str(v) for v in
                                (eid, etype, ntags, *tags, *nodes)))
        done += nel
    out.append("$EndElements")
    return "\n".join(out) + "\n"


def read_gmsh(path_or_text):
    """Parse MSH 2.2 ASCII into a Plex (tri/quad/tet/hex picked from
    the highest-dimensional block) with labels:

      * "Cell Sets":  physical tag -> cell points
      * "Face Sets":  physical tag -> facet closures (vertex points)
      * one label per $PhysicalNames name, same strata

    Returns the plex. Raises on binary files or mixed cell types.
    """
    import os

    from petsctpu_torch.dm.label import create_label, vertex_point
    from petsctpu_torch.dm.plex import Plex, Plex3D, PlexHex, PlexQuad

    if isinstance(path_or_text, (bytes, bytearray)):
        raw = bytes(path_or_text)
        text = (_binary_msh_to_ascii(raw) if _is_binary_msh(raw)
                else raw.decode())
    elif isinstance(path_or_text, str) and os.path.exists(path_or_text):
        with open(path_or_text, "rb") as f:
            raw = f.read()
        text = (_binary_msh_to_ascii(raw) if _is_binary_msh(raw)
                else raw.decode())
    else:
        text = path_or_text
    lines = [ln.strip() for ln in text.splitlines()]
    i = 0

    def section(name):
        nonlocal i
        while i < len(lines) and lines[i] != f"${name}":
            i += 1
        if i >= len(lines):
            return None
        i += 1
        start = i
        while lines[i] != f"$End{name}":
            i += 1
        body = lines[start:i]
        i += 1
        return body

    fmt = section("MeshFormat")
    if fmt is not None:
        ver, ftype = fmt[0].split()[:2]
        if not ver.startswith("2"):
            raise ValueError(f"gmsh: only MSH 2.x ASCII supported "
                             f"(got version {ver})")
        if ftype != "0":
            raise ValueError("gmsh: binary MSH reaches the text parser"
                             " unconverted (internal error)")

    i = 0
    names = {}
    pn = section("PhysicalNames")
    if pn is not None:
        for ln in pn[1:]:
            parts = ln.split(None, 2)
            names[int(parts[1])] = parts[2].strip().strip('"')

    i = 0
    nb = section("Nodes")
    if nb is None:
        raise ValueError("gmsh: no $Nodes section")
    nn = int(nb[0])
    ids = np.empty(nn, np.int64)
    xyz = np.empty((nn, 3), np.float64)
    for k, ln in enumerate(nb[1:1 + nn]):
        p = ln.split()
        ids[k] = int(p[0])
        xyz[k] = [float(p[1]), float(p[2]), float(p[3])]
    remap = {int(v): k for k, v in enumerate(ids)}

    i = 0
    eb = section("Elements")
    if eb is None:
        raise ValueError("gmsh: no $Elements section")
    ne = int(eb[0])
    elems = []                      # (dim, etype, phys, node ids)
    for ln in eb[1:1 + ne]:
        p = [int(x) for x in ln.split()]
        etype = p[1]
        if etype not in _ELEM:
            raise ValueError(f"gmsh: unsupported element type {etype}")
        nnod, dim = _ELEM[etype]
        ntags = p[2]
        phys = p[3] if ntags >= 1 else 0
        nodes = [remap[n] for n in p[3 + ntags:3 + ntags + nnod]]
        elems.append((dim, etype, phys, nodes))

    maxdim = max(e[0] for e in elems)
    cells_by_type: dict = {}
    for dim, etype, phys, nodes in elems:
        if dim == maxdim:
            cells_by_type.setdefault(etype, []).append((phys, nodes))
    if len(cells_by_type) != 1:
        raise ValueError(f"gmsh: mixed cell types "
                         f"{sorted(cells_by_type)} not supported")
    (etype, cell_list), = cells_by_type.items()
    cphys = np.asarray([p for p, _ in cell_list], np.int64)
    cells = np.asarray([n for _, n in cell_list], np.int64)

    coords = xyz[:, :2] if maxdim == 2 else xyz
    used = np.unique(cells.reshape(-1))
    if len(used) != len(remap):
        # drop orphan nodes (gmsh files often carry embedded points)
        new_id = np.full(len(remap), -1, np.int64)
        new_id[used] = np.arange(len(used))
        cells = new_id[cells]
        coords = coords[used]
        node_map = new_id
    else:
        node_map = np.arange(len(remap))

    mk = {2: Plex, 3: PlexQuad, 4: Plex3D, 5: PlexHex}[etype]
    plex = mk(cells=cells, coords=np.ascontiguousarray(coords))

    # labels: cell regions
    cs = create_label(plex, "Cell Sets")
    for v in np.unique(cphys):
        cs.set_value(np.flatnonzero(cphys == v), int(v))
    # facet groups (dim = maxdim-1): FIRST-CLASS facet points via the
    # interpolated strata (DMPlexInterpolate, plex.c:3893/:4031) —
    # two adjacent groups sharing vertices stay distinct, and
    # facet-integral (Neumann/Robin) BCs can consume the label;
    # unmatched facet elements fall back to vertex closures
    from petsctpu_torch.dm.interp import face_point, match_faces
    fs = create_label(plex, "Face Sets")
    for dim, et, phys, nodes in elems:
        if dim == maxdim - 1 and phys:
            nd = node_map[np.asarray(nodes, np.int64)]
            nd = nd[nd >= 0]
            fid = match_faces(plex, nd[None, :])[0] \
                if len(nd) else -1
            if fid >= 0:
                fs.set_value(face_point(plex, [fid]), int(phys))
            else:
                fs.set_value(vertex_point(plex, nd), int(phys))
    # named physical groups as standalone labels
    for tag, nm in names.items():
        lab = create_label(plex, nm)
        pts = fs.stratum(tag)
        if len(pts):
            lab.set_value(pts, tag)
        cpts = cs.stratum(tag)
        if len(cpts):
            lab.set_value(cpts, tag)
    return plex


def write_gmsh(plex, path: str) -> None:
    """Write a Plex as MSH 2.2 ASCII (round-trip/testing aid)."""
    coords = np.asarray(plex.coords, float)
    dim = coords.shape[1]
    if dim == 2:
        coords = np.hstack([coords, np.zeros((len(coords), 1))])
    cells = np.asarray(plex.cells)
    nnod = cells.shape[1]
    etype = {(3, 2): 2, (4, 2): 3, (4, 3): 4, (8, 3): 5}[(nnod, dim)]
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{len(coords)}\n")
        for k, (x, y, z) in enumerate(coords):
            f.write(f"{k + 1} {x:.16g} {y:.16g} {z:.16g}\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{len(cells)}\n")
        for k, c in enumerate(cells):
            nodes = " ".join(str(v + 1) for v in c)
            f.write(f"{k + 1} {etype} 2 0 0 {nodes}\n")
        f.write("$EndElements\n")
