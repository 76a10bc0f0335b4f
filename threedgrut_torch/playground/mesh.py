"""Triangle meshes for the playground path tracer, port of
threedgrut_tpu/playground/mesh.py: the mesh container (vertex normals and
UV-aligned tangents), primitive generators, a minimal OBJ loader, and the
closest hit of every ray (kernel M1, ops/mesh_intersect.py, with the hit's
normal, UV and tangent interpolated by torch gathers).

The reference system builds a second OptiX BVH over the mesh triangles and
intersects through hardware closest-hit; the playground's meshes are small
props (mirrors, glass), for which the dense test over every face is exact.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from threedgrut_torch.device import resolve
from threedgrut_torch.ops import mesh_intersect


@dataclasses.dataclass
class TriangleMesh:
    vertices: torch.Tensor         # [V, 3]
    faces: torch.Tensor            # [F, 3] int32
    vertex_normals: torch.Tensor   # [V, 3]
    material_id: torch.Tensor      # [F] int32
    uvs: torch.Tensor              # [V, 2] texture coordinates
    vertex_tangents: torch.Tensor  # [V, 3] (UV-aligned, for normal maps)

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    def to(self, device) -> "TriangleMesh":
        return TriangleMesh(**{f: getattr(self, f).to(device)
                               for f in FIELDS})


FIELDS = tuple(f.name for f in dataclasses.fields(TriangleMesh))


def from_numpy(fields, device="cuda") -> TriangleMesh:
    """The JAX TriangleMesh's fields (numpy arrays) -> the port's, on
    `device`."""
    dev = resolve(device)
    return TriangleMesh(**{f: torch.tensor(np.asarray(fields[f]), device=dev)
                           for f in FIELDS})


def _vertex_tangents(v, f, vn, uv):
    """Per-vertex tangents from UV derivatives, orthogonalized against the
    normal (an arbitrary frame where the UVs are degenerate)."""
    e1 = v[f[:, 1]] - v[f[:, 0]]
    e2 = v[f[:, 2]] - v[f[:, 0]]
    du1 = uv[f[:, 1]] - uv[f[:, 0]]
    du2 = uv[f[:, 2]] - uv[f[:, 0]]
    det = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    tan_f = (e1 * du2[:, 1:2] - e2 * du1[:, 1:2]) * r[:, None]
    vt = np.zeros_like(v)
    for k in range(3):
        np.add.at(vt, f[:, k], tan_f)
    vt = vt - vn * np.sum(vt * vn, -1, keepdims=True)
    bad = np.linalg.norm(vt, axis=-1) < 1e-8
    alt = np.cross(vn, np.where(np.abs(vn[:, 2:3]) < 0.9,
                                [[0.0, 0.0, 1.0]], [[1.0, 0.0, 0.0]]))
    vt = np.where(bad[:, None], alt, vt)
    return vt / np.maximum(np.linalg.norm(vt, axis=-1, keepdims=True), 1e-12)


def make_mesh(vertices, faces, material_id: int = 0, uvs=None, normals=None,
              material_ids=None, device="cuda") -> TriangleMesh:
    """A mesh on `device`: area-weighted vertex normals unless given, zero
    UVs unless given, vertex tangents, one material id or per-face ones;
    computed in numpy as the JAX package's make_mesh is."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int32)
    if normals is None:
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        fn = np.cross(e1, e2)
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, f[:, k], fn)
        vn = vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True),
                             1e-12)
    else:
        vn = np.asarray(normals, np.float32)
    uv = (np.zeros((v.shape[0], 2), np.float32) if uvs is None
          else np.asarray(uvs, np.float32))
    mid = (np.full((f.shape[0],), material_id, np.int32)
           if material_ids is None else np.asarray(material_ids, np.int32))
    # The tangents are computed in float64 where numpy promotes, and stored
    # in float32, as the JAX package's arrays are.
    return from_numpy(dict(
        vertices=v, faces=f, vertex_normals=vn, material_id=mid, uvs=uv,
        vertex_tangents=_vertex_tangents(v, f, vn, uv).astype(np.float32)),
        device)


def merge_meshes(meshes) -> TriangleMesh:
    """One mesh of all (on the first one's device), face indices offset."""
    off, faces = 0, []
    for m in meshes:
        faces.append(m.faces + off)
        off += m.vertices.shape[0]
    out = {f: torch.cat([getattr(m, f) for m in meshes]) for f in FIELDS
           if f != "faces"}
    return TriangleMesh(faces=torch.cat(faces), **out)


def load_obj(path: str, material_id: int = 0, device="cuda") -> TriangleMesh:
    """Minimal OBJ loader: `v` and `f` lines (polygons as triangle
    fans)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                verts.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                idx = [int(w.split("/")[0]) - 1 for w in t[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return make_mesh(np.asarray(verts, np.float32),
                     np.asarray(faces, np.int32), material_id, device=device)


def make_quad(center, u, v, material_id=0, device="cuda") -> TriangleMesh:
    c = np.asarray(center, np.float32)
    u = np.asarray(u, np.float32)
    v = np.asarray(v, np.float32)
    verts = np.stack([c - u - v, c + u - v, c + u + v, c - u + v])
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return make_mesh(verts, faces, material_id, device=device)


def make_icosphere(center, radius, subdivisions=1, material_id=0,
                   device="cuda") -> TriangleMesh:
    """Icosahedron subdivided `subdivisions` times (20 x 4^k faces)."""
    phi = (1 + 5 ** 0.5) / 2
    verts = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        mid = {}
        new_faces = []
        verts = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2
                mid[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        faces = np.asarray(new_faces)
        verts = np.asarray(verts)
    verts = np.asarray(verts, np.float32) * radius + np.asarray(
        center, np.float32)
    return make_mesh(verts, faces.astype(np.int32), material_id,
                     device=device)


class MeshHit(NamedTuple):
    t: torch.Tensor            # [R] hit distance (inf = miss)
    face: torch.Tensor         # [R] int32 face index (-1 = miss)
    normal: torch.Tensor       # [R, 3] interpolated shading normal
    material_id: torch.Tensor  # [R] int32 (-1 = miss)
    bary: torch.Tensor         # [R, 2] barycentric (u, w)
    uv: torch.Tensor           # [R, 2] interpolated texture coordinates
    tangent: torch.Tensor      # [R, 3] interpolated tangent


def _unit(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def intersect(mesh: Optional[TriangleMesh], rays_o: torch.Tensor,
              rays_d: torch.Tensor, t_min: float = 1e-4) -> MeshHit:
    """Closest hit of each ray [R, 3] over every face (M1), with the hit's
    interpolated normal, UV and tangent."""
    r = rays_o.shape[0]
    dev = rays_o.device
    if mesh is None or mesh.num_faces == 0:
        return MeshHit(
            t=torch.full((r,), float("inf"), device=dev),
            face=torch.full((r,), -1, dtype=torch.int32, device=dev),
            normal=torch.zeros((r, 3), device=dev),
            material_id=torch.full((r,), -1, dtype=torch.int32, device=dev),
            bary=torch.zeros((r, 2), device=dev),
            uv=torch.zeros((r, 2), device=dev),
            tangent=torch.zeros((r, 3), device=dev))
    tri = mesh_intersect.triangles(mesh.vertices, mesh.faces)
    best_t, best_face, uu, ww = mesh_intersect.closest_hits(
        rays_o.contiguous(), rays_d.contiguous(), tri, t_min)
    hitf = torch.clamp(best_face, 0, mesh.num_faces - 1).to(torch.int64)
    fidx = mesh.faces[hitf].to(torch.int64)
    uu, ww = uu[:, None], ww[:, None]
    w0 = 1 - uu - ww

    def interp(attr):
        return (attr[fidx[:, 0]] * w0 + attr[fidx[:, 1]] * uu
                + attr[fidx[:, 2]] * ww)

    miss = ~torch.isfinite(best_t)
    normal = _unit(interp(mesh.vertex_normals))
    return MeshHit(
        t=best_t,
        face=best_face,
        normal=torch.where(miss[:, None], torch.zeros_like(normal), normal),
        material_id=torch.where(miss, -1, mesh.material_id[hitf]),
        bary=torch.cat([uu, ww], dim=1),
        uv=interp(mesh.uvs),
        tangent=_unit(interp(mesh.vertex_tangents)))
