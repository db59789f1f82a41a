"""Wavefront OBJ load/save (host-side, numpy).

Capability parity with the reference's parallel OBJ loader
(tools/OBJ_loader.cpp:278-361): v/vt/vn records, all four face-vertex forms
(``v``, ``v/vt``, ``v//vn``, ``v/vt/vn``), negative (relative) indices with
1-based -> 0-based fixup (OBJ_loader.cpp:229-267), n-gon faces via fan
triangulation, and ``usemtl`` grouping. The reference parallelizes parsing
across threads because it hand-rolls float parsing per byte; at these asset
sizes (<10 MB) a vectorized numpy pass on the host is faster and simpler, and
the device hot path never touches this code.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from atray.scene.data import TriMesh, _f32, _i32


def _fix_index(idx: int, count: int) -> int:
    """OBJ 1-based / negative-relative index -> 0-based absolute."""
    return idx - 1 if idx > 0 else count + idx


def load_obj(
    path: str,
    material_map: Optional[Dict[str, int]] = None,
    default_material: int = 1,
    backend: str = "auto",
) -> TriMesh:
    """Parse an OBJ file into a TriMesh.

    ``material_map`` maps ``usemtl`` names to material indices in the scene's
    material table; unmapped names and untagged faces get ``default_material``.

    ``backend="auto"`` uses the native C++ parser (native/atray_native.cpp)
    when no per-material grouping is requested (it does not track usemtl);
    otherwise, or when the native library is unavailable, the python parser
    runs.
    """
    if backend in ("auto", "native") and not material_map:
        from atray.native import parse_obj_native

        nat = parse_obj_native(path)
        if nat is not None and nat["vertices"].shape[0] > 0:
            t = nat["faces"].shape[0]
            return TriMesh(
                vertices=_f32(nat["vertices"]),
                faces=_i32(nat["faces"]),
                normals=_f32(
                    nat["normals"] if nat["normals"].shape[0]
                    else np.zeros((1, 3), np.float32)
                ),
                face_normal_idx=_i32(nat["face_normal_idx"]),
                tex_coords=_f32(
                    nat["tex_coords"] if nat["tex_coords"].shape[0]
                    else np.zeros((1, 2), np.float32)
                ),
                face_tex_idx=_i32(nat["face_tex_idx"]),
                material_id=_i32(np.full((t,), default_material, np.int32)),
            )
        if backend == "native":
            raise RuntimeError(f"native OBJ parse failed for {path!r}")
    verts: List[Tuple[float, float, float]] = []
    norms: List[Tuple[float, float, float]] = []
    texs: List[Tuple[float, float]] = []
    faces: List[Tuple[int, int, int]] = []
    f_nidx: List[Tuple[int, int, int]] = []
    f_tidx: List[Tuple[int, int, int]] = []
    f_mat: List[int] = []
    cur_mat = default_material

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vn":
                norms.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vt":
                texs.append((float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0))
            elif tag == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                cur_mat = (material_map or {}).get(name, default_material)
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    fields = tok.split("/")
                    vi = _fix_index(int(fields[0]), len(verts))
                    ti = (
                        _fix_index(int(fields[1]), len(texs))
                        if len(fields) > 1 and fields[1]
                        else -1
                    )
                    ni = (
                        _fix_index(int(fields[2]), len(norms))
                        if len(fields) > 2 and fields[2]
                        else -1
                    )
                    corners.append((vi, ti, ni))
                # Fan-triangulate n-gons (triangles pass through unchanged).
                for k in range(1, len(corners) - 1):
                    tri = (corners[0], corners[k], corners[k + 1])
                    faces.append(tuple(c[0] for c in tri))
                    f_tidx.append(tuple(c[1] for c in tri))
                    f_nidx.append(tuple(c[2] for c in tri))
                    f_mat.append(cur_mat)

    if not verts:
        raise ValueError(f"OBJ file {path!r} contains no vertices")

    return TriMesh(
        vertices=_f32(np.asarray(verts, np.float32)),
        faces=_i32(np.asarray(faces, np.int32).reshape(-1, 3)),
        normals=_f32(
            np.asarray(norms, np.float32) if norms else np.zeros((1, 3), np.float32)
        ),
        face_normal_idx=_i32(np.asarray(f_nidx, np.int32).reshape(-1, 3)),
        tex_coords=_f32(
            np.asarray(texs, np.float32) if texs else np.zeros((1, 2), np.float32)
        ),
        face_tex_idx=_i32(np.asarray(f_tidx, np.int32).reshape(-1, 3)),
        material_id=_i32(np.asarray(f_mat, np.int32)),
    )


def save_obj(path: str, mesh: TriMesh) -> None:
    """Write a TriMesh back to OBJ (round-trip testing + interop)."""
    v = np.asarray(mesh.vertices)
    n = np.asarray(mesh.normals)
    t = np.asarray(mesh.tex_coords)
    f = np.asarray(mesh.faces)
    fn = np.asarray(mesh.face_normal_idx)
    ft = np.asarray(mesh.face_tex_idx)
    has_n = bool((fn >= 0).any())
    has_t = bool((ft >= 0).any())
    with open(path, "w") as fh:
        fh.write("# atray mesh\n")
        for row in v:
            fh.write(f"v {row[0]:.9g} {row[1]:.9g} {row[2]:.9g}\n")
        if has_t:
            for row in t:
                fh.write(f"vt {row[0]:.9g} {row[1]:.9g}\n")
        if has_n:
            for row in n:
                fh.write(f"vn {row[0]:.9g} {row[1]:.9g} {row[2]:.9g}\n")
        for i in range(f.shape[0]):
            toks = []
            for c in range(3):
                vi = f[i, c] + 1
                if has_n and fn[i, c] >= 0:
                    ti = str(ft[i, c] + 1) if has_t and ft[i, c] >= 0 else ""
                    toks.append(f"{vi}/{ti}/{fn[i, c] + 1}")
                elif has_t and ft[i, c] >= 0:
                    toks.append(f"{vi}/{ft[i, c] + 1}")
                else:
                    toks.append(str(vi))
            fh.write("f " + " ".join(toks) + "\n")
