"""ExodusII-lite mesh reader.

Counterpart of petsctpu/dm/exodus.py: host parsing, as there.

Reference: DMPlexCreateExodus (src/dm/impls/plex/plexexodusii.c:13) —
the reference reads ExodusII (a NetCDF3-classic container) through the
external exodusII/netcdf libraries. Here the container is parsed with
scipy.io.netcdf_file (pure python, no external C libs) and the mesh
lands in the same Plex + DMLabel shape the Gmsh reader produces:

  * element blocks  -> cells (+ "Cell Sets" label, value = block id)
  * node sets       -> "Vertex Sets" label values on vertex points
  * side sets       -> "Face Sets" label values on FACE points
                       (dm/interp.py strata; the (element, local-side)
                       pairs are resolved through the ExodusII side
                       numbering conventions below)

Supported cell types: TRI3, QUAD4, TET4, HEX8 (one homogeneous cell
type per file — blocks may repeat the type; mixed types raise).
"""

from __future__ import annotations

import numpy as np

# ExodusII local-side -> local vertex tuples (1-based in the manual;
# stored 0-based here), per element type
_SIDES = {
    "TRI3": [(0, 1), (1, 2), (2, 0)],
    "QUAD4": [(0, 1), (1, 2), (2, 3), (3, 0)],
    "TET4": [(0, 1, 3), (1, 2, 3), (0, 3, 2), (0, 2, 1)],
    "HEX8": [(0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6),
             (0, 4, 7, 3), (0, 3, 2, 1), (4, 5, 6, 7)],
}
_NPC = {"TRI3": 3, "QUAD4": 4, "TET4": 4, "HEX8": 8}


def _plex_class(elem_type: str, dim: int):
    from petsctpu_torch.dm.plex import Plex, Plex3D, PlexHex, PlexQuad
    return {"TRI3": Plex, "QUAD4": PlexQuad,
            "TET4": Plex3D, "HEX8": PlexHex}[elem_type]


def read_exodus(path):
    """DMPlexCreateExodus analog: path (or file-like) -> Plex with
    Cell/Vertex/Face Sets labels."""
    from scipy.io import netcdf_file

    from petsctpu_torch.dm.interp import face_point, match_faces
    from petsctpu_torch.dm.label import create_label, vertex_point

    nc = netcdf_file(path, "r", mmap=False)
    try:
        dims = nc.dimensions
        ndim = int(dims["num_dim"])
        nblk = int(dims.get("num_el_blk", 1))

        # coordinates: either one (num_dim, num_nodes) `coord` or
        # separate coordx/coordy/coordz
        if "coord" in nc.variables:
            coords = np.array(nc.variables["coord"][:]).T
        else:
            axes = [np.array(nc.variables[f"coord{ax}"][:])
                    for ax in "xyz"[:ndim]]
            coords = np.stack(axes, axis=1)
        coords = np.asarray(coords[:, :ndim], float)

        blocks, types, blk_of_cell = [], [], []
        for b in range(1, nblk + 1):
            v = nc.variables[f"connect{b}"]
            et = (v.elem_type.decode() if isinstance(v.elem_type, bytes)
                  else str(v.elem_type)).upper()
            et = {"TRI": "TRI3", "QUAD": "QUAD4", "TETRA": "TET4",
                  "TET": "TET4", "HEX": "HEX8"}.get(et, et)
            if et not in _NPC:
                raise ValueError(f"unsupported Exodus elem_type {et!r}")
            conn = np.array(v[:], np.int64) - 1          # 1-based
            blocks.append(conn)
            types.append(et)
            blk_of_cell.append(np.full(conn.shape[0], b, np.int64))
        if len(set(types)) != 1:
            raise ValueError(f"mixed element types {set(types)} not "
                             "supported")
        et = types[0]
        cells = np.concatenate(blocks, axis=0)
        plex = _plex_class(et, ndim)(cells, coords)

        # Cell Sets: value = block id (eb_prop1 when present)
        ids = (np.array(nc.variables["eb_prop1"][:], np.int64)
               if "eb_prop1" in nc.variables
               else np.arange(1, nblk + 1))
        cs = create_label(plex, "Cell Sets")
        off = 0
        for b in range(nblk):
            nc_b = blocks[b].shape[0]
            cs.set_value(np.arange(off, off + nc_b), int(ids[b]))
            off += nc_b

        # node sets -> Vertex Sets on vertex points
        nns = int(dims.get("num_node_sets", 0) or 0)
        if nns:
            nsids = (np.array(nc.variables["ns_prop1"][:], np.int64)
                     if "ns_prop1" in nc.variables
                     else np.arange(1, nns + 1))
            vs = create_label(plex, "Vertex Sets")
            for k in range(1, nns + 1):
                nodes = np.array(nc.variables[f"node_ns{k}"][:],
                                 np.int64) - 1
                vs.set_value(vertex_point(plex, nodes), int(nsids[k - 1]))

        # side sets -> Face Sets on FACE points via the side tables
        nss = int(dims.get("num_side_sets", 0) or 0)
        if nss:
            ssids = (np.array(nc.variables["ss_prop1"][:], np.int64)
                     if "ss_prop1" in nc.variables
                     else np.arange(1, nss + 1))
            fs = create_label(plex, "Face Sets")
            side_tab = _SIDES[et]
            for k in range(1, nss + 1):
                els = np.array(nc.variables[f"elem_ss{k}"][:],
                               np.int64) - 1
                sds = np.array(nc.variables[f"side_ss{k}"][:],
                               np.int64) - 1
                fnodes = np.stack([cells[e][list(side_tab[s])]
                                   for e, s in zip(els, sds)])
                fids = match_faces(plex, fnodes)
                if (fids < 0).any():
                    raise ValueError(f"side set {k}: side not a mesh "
                                     "face")
                fs.set_value(face_point(plex, fids), int(ssids[k - 1]))
        return plex
    finally:
        nc.close()


def write_exodus(path, plex, cell_sets=True) -> None:
    """Minimal ExodusII writer (one element block; Vertex/Face Sets
    labels become node/side sets) — enough for round-tripping our own
    meshes and feeding Exodus-consuming tools."""
    from scipy.io import netcdf_file

    from petsctpu_torch.dm.interp import interpolate, point_face
    from petsctpu_torch.dm.label import get_label, point_vertex

    cells = np.asarray(plex.cells)
    coords = np.asarray(plex.coords, float)
    nc_, npc = cells.shape
    ndim = coords.shape[1]
    et = {(3, 2): "TRI3", (4, 2): "QUAD4", (4, 3): "TET4",
          (8, 3): "HEX8"}[(npc, ndim)]

    f = netcdf_file(path, "w")
    try:
        f.createDimension("num_dim", ndim)
        f.createDimension("num_nodes", coords.shape[0])
        f.createDimension("num_elem", nc_)
        f.createDimension("num_el_blk", 1)
        f.createDimension("num_el_in_blk1", nc_)
        f.createDimension("num_nod_per_el1", npc)
        v = f.createVariable("coord", "d", ("num_dim", "num_nodes"))
        v[:] = coords.T
        c = f.createVariable("connect1", "i",
                             ("num_el_in_blk1", "num_nod_per_el1"))
        c[:] = (cells + 1).astype(np.int32)
        c.elem_type = et
        fs = get_label(plex, "Face Sets")
        if fs is not None and fs.values():
            it = interpolate(plex)
            side_tab = _SIDES[et]
            # face -> (cell, local side) via sorted side-node keys
            keys = {}
            for ci in range(nc_):
                for s, loc in enumerate(side_tab):
                    keys[tuple(np.sort(cells[ci][list(loc)]))] = (ci, s)
            f.createDimension("num_side_sets", len(fs.values()))
            sp_ = f.createVariable("ss_prop1", "i", ("num_side_sets",))
            sp_[:] = np.asarray(fs.values(), np.int32)
            for k, val in enumerate(fs.values(), 1):
                fids = point_face(plex, fs.stratum(val))
                pairs = [keys[tuple(np.sort(it.faces[int(fi)]))]
                         for fi in fids]
                f.createDimension(f"num_side_ss{k}", len(pairs))
                e_ = f.createVariable(f"elem_ss{k}", "i",
                                      (f"num_side_ss{k}",))
                e_[:] = np.asarray([p[0] + 1 for p in pairs], np.int32)
                s_ = f.createVariable(f"side_ss{k}", "i",
                                      (f"num_side_ss{k}",))
                s_[:] = np.asarray([p[1] + 1 for p in pairs], np.int32)
        vsl = get_label(plex, "Vertex Sets")
        if vsl is not None and vsl.values():
            f.createDimension("num_node_sets", len(vsl.values()))
            np_ = f.createVariable("ns_prop1", "i", ("num_node_sets",))
            np_[:] = np.asarray(vsl.values(), np.int32)
            for k, val in enumerate(vsl.values(), 1):
                nodes = point_vertex(plex, vsl.stratum(val))
                f.createDimension(f"num_nod_ns{k}", len(nodes))
                n_ = f.createVariable(f"node_ns{k}", "i",
                                      (f"num_nod_ns{k}",))
                n_[:] = (np.asarray(nodes) + 1).astype(np.int32)
    finally:
        f.close()
