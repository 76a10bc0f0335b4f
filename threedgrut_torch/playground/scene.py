"""Editable playground scene graph, port of
threedgrut_tpu/playground/scene.py: named mesh primitives with per-object
transforms, visibility and material assignment (the reference system's
`Primitives`), stacked into one merged TriangleMesh for the engine, and an
editable material table. Edits change host-side state; `mesh()` and
`materials()` rebuild the stacked tensors on the scene's device when an
edit has made them stale.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from threedgrut_torch.device import resolve
from threedgrut_torch.playground import materials as mat_mod
from threedgrut_torch.playground import mesh as mesh_mod


def _norm(x):
    return np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


@dataclasses.dataclass
class Primitive:
    """One named scene object: an immutable base mesh and an editable
    pose."""
    name: str
    base: mesh_mod.TriangleMesh          # untransformed geometry
    translation: np.ndarray              # [3]
    rotation_euler: np.ndarray           # [3] XYZ intrinsic, radians
    scale: float = 1.0
    visible: bool = True
    material_id: Optional[int] = None    # None: keep the per-face ids

    def transform_matrix(self) -> np.ndarray:
        rx, ry, rz = self.rotation_euler
        cx, sx = np.cos(rx), np.sin(rx)
        cy, sy = np.cos(ry), np.sin(ry)
        cz, sz = np.cos(rz), np.sin(rz)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return (Rz @ Ry @ Rx) * self.scale

    def transformed(self) -> mesh_mod.TriangleMesh:
        M = self.transform_matrix()
        dev = self.base.vertices.device

        def arr(x):
            return x.detach().cpu().numpy()

        v = arr(self.base.vertices) @ M.T + self.translation
        # Normals and tangents rotate (a uniform scale keeps them
        # orthogonal up to the renormalization).
        R = M / max(self.scale, 1e-12)
        n = arr(self.base.vertex_normals) @ R.T
        t = arr(self.base.vertex_tangents) @ R.T
        mid = self.base.material_id
        if self.material_id is not None:
            mid = torch.full_like(mid, int(self.material_id))

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=dev)

        return mesh_mod.TriangleMesh(
            vertices=f32(v), faces=self.base.faces,
            vertex_normals=f32(n / _norm(n)), material_id=mid,
            uvs=self.base.uvs, vertex_tangents=f32(t / _norm(t)))


class SceneGraph:
    """Named primitives and an editable material table, stacked for the
    Engine. `material_specs` is materials.make_materials' list of dicts;
    an edit rewrites a field and the table is rebuilt (textures kept)."""

    def __init__(self, primitives: Optional[List[Primitive]] = None,
                 material_specs: Optional[List[dict]] = None,
                 device="cuda"):
        self.device = resolve(device)
        self.primitives: Dict[str, Primitive] = {
            p.name: p for p in (primitives or [])}
        self.material_specs: List[dict] = material_specs or [
            dict(kind=mat_mod.MaterialKind.DIFFUSE)]
        self._mesh = None
        self._materials = None

    # -- primitives ----------------------------------------------------------
    def add(self, name: str, base: mesh_mod.TriangleMesh,
            translation=(0, 0, 0), rotation_euler=(0, 0, 0),
            scale: float = 1.0,
            material_id: Optional[int] = None) -> Primitive:
        """Add a primitive; a taken name gets the first free `_<i>`
        suffix, i >= 2."""
        if name in self.primitives:
            i = 2
            while f"{name}_{i}" in self.primitives:
                i += 1
            name = f"{name}_{i}"
        p = Primitive(name=name, base=base.to(self.device),
                      translation=np.asarray(translation, np.float64),
                      rotation_euler=np.asarray(rotation_euler, np.float64),
                      scale=float(scale), material_id=material_id)
        self.primitives[name] = p
        self._mesh = None
        return p

    def duplicate(self, name: str) -> Primitive:
        src = self.primitives[name]
        return self.add(src.name, src.base,
                        translation=src.translation + [0.1, 0.1, 0.0],
                        rotation_euler=src.rotation_euler, scale=src.scale,
                        material_id=src.material_id)

    def remove(self, name: str) -> None:
        self.primitives.pop(name, None)
        self._mesh = None

    def update(self, name: str, **fields) -> None:
        p = self.primitives[name]
        for k, v in fields.items():
            if k in ("translation", "rotation_euler"):
                v = np.asarray(v, np.float64)
            elif k == "scale":
                v = float(v)
            elif k == "visible":
                v = bool(v)
            elif k == "material_id":
                v = None if v is None else int(v)
            else:
                raise KeyError(k)
            setattr(p, k, v)
        self._mesh = None

    # -- materials -----------------------------------------------------------
    def set_material(self, mat_id: int, **fields) -> None:
        spec = self.material_specs[mat_id]
        for k, v in fields.items():
            if k not in ("kind", "base_color", "metallic", "roughness",
                         "ior", "emissive"):
                raise KeyError(k)
            spec[k] = (int(v) if k == "kind"
                       else tuple(float(x) for x in v)
                       if k in ("base_color", "emissive") else float(v))
        self._materials = None

    def add_material(self, spec: dict) -> int:
        self.material_specs.append(dict(spec))
        self._materials = None
        return len(self.material_specs) - 1

    # -- stacked buffers -----------------------------------------------------
    def mesh(self) -> Optional[mesh_mod.TriangleMesh]:
        if self._mesh is None:
            vis = [p.transformed() for p in self.primitives.values()
                   if p.visible]
            self._mesh = mesh_mod.merge_meshes(vis) if vis else None
        return self._mesh

    def materials(self) -> mat_mod.Materials:
        if self._materials is None:
            self._materials = mat_mod.make_materials(self.material_specs,
                                                     self.device)
        return self._materials

    # -- JSON state for the viewer --------------------------------------------
    def describe(self) -> dict:
        prims = {}
        for n, p in self.primitives.items():
            prims[n] = dict(
                translation=list(map(float, p.translation)),
                rotation_euler=list(map(float, p.rotation_euler)),
                scale=p.scale, visible=p.visible,
                material_id=p.material_id,
                num_faces=int(p.base.num_faces))
        mats = []
        for s in self.material_specs:
            mats.append(dict(
                kind=int(s.get("kind", 0)),
                base_color=list(s.get("base_color", (0.8, 0.8, 0.8))),
                metallic=float(s.get("metallic", 0.0)),
                roughness=float(s.get("roughness", 0.5)),
                ior=float(s.get("ior", 1.5)),
                emissive=list(s.get("emissive", (0.0, 0.0, 0.0))),
                has_texture=s.get("base_color_texture") is not None,
                has_normal_map=s.get("normal_texture") is not None))
        return dict(primitives=prims, materials=mats)
