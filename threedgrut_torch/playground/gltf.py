"""Minimal binary glTF (.glb) loader for playground mesh assets, port of
threedgrut_tpu/playground/gltf.py (the reference system loads them with
kaolin).

Parses the GLB container (JSON and BIN chunks), reads POSITION, NORMAL,
TEXCOORD_0 and the indices of every mesh primitive, applies the node
transforms, and turns glTF pbrMetallicRoughness materials
(baseColorFactor/Texture, metallic and roughness factors, normalTexture,
emissiveFactor) into playground material specs. Embedded textures are
decoded with PIL; only where PIL is not installed does a material keep
its factors without its textures. A texture that fails to decode raises
(the JAX loader drops it silently). Images referenced by URI rather than
embedded in the BIN chunk are not loaded, as in the JAX loader.
"""
from __future__ import annotations

import io
import json
import struct
from typing import Optional, Tuple

import numpy as np

from threedgrut_torch.playground import materials as mat_mod
from threedgrut_torch.playground import mesh as mesh_mod

_COMPONENT = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
              5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}
_GLB_MAGIC = 0x46546C67       # "glTF"
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942


def _read_accessor(gltf, bin_blob, idx):
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT[acc["componentType"]]
    n = _NCOMP[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride", 0)
    elem = np.dtype(dtype).itemsize * n
    if stride and stride != elem:
        raw = bin_blob[offset:offset + stride * count]
        out = np.zeros((count, n), dtype)
        for i in range(count):
            out[i] = np.frombuffer(raw, dtype, n, i * stride)
        return out
    return np.frombuffer(bin_blob, dtype, count * n, offset).reshape(count, n)


def _decode_image(gltf, bin_blob, tex_index) -> Optional[np.ndarray]:
    """The texture's embedded image as [H, W, 3] f32 in [0, 1]; None for
    an image referenced by URI, or where PIL is not installed."""
    tex = gltf["textures"][tex_index]
    img = gltf["images"][tex["source"]]
    if "bufferView" not in img:
        return None
    try:
        from PIL import Image
    except ImportError:
        return None
    view = gltf["bufferViews"][img["bufferView"]]
    off = view.get("byteOffset", 0)
    data = bin_blob[off:off + view["byteLength"]]
    with Image.open(io.BytesIO(data)) as pic:
        return np.asarray(pic.convert("RGB"), np.float32) / 255.0


def _node_transforms(gltf):
    """World matrix of every node (glTF matrices are column-major)."""
    nodes = gltf.get("nodes", [])

    def local(nd):
        if "matrix" in nd:
            return np.asarray(nd["matrix"], np.float32).reshape(4, 4).T
        m = np.eye(4, dtype=np.float32)
        if "scale" in nd:
            m = m @ np.diag(list(nd["scale"]) + [1.0]).astype(np.float32)
        if "rotation" in nd:
            x, y, z, w = nd["rotation"]
            r = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)]], np.float32)
            rm = np.eye(4, dtype=np.float32)
            rm[:3, :3] = r
            m = rm @ m
        if "translation" in nd:
            tm = np.eye(4, dtype=np.float32)
            tm[:3, 3] = nd["translation"]
            m = tm @ m
        return m

    world = [None] * len(nodes)

    def walk(i, parent):
        world[i] = parent @ local(nodes[i])
        for c in nodes[i].get("children", []):
            walk(c, world[i])

    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    for root in scene.get("nodes", range(len(nodes))):
        walk(root, np.eye(4, dtype=np.float32))
    return [np.eye(4, dtype=np.float32) if w is None else w for w in world]


def load_glb(path: str, device="cuda"
             ) -> Tuple[Optional[mesh_mod.TriangleMesh], mat_mod.Materials]:
    """A .glb as (merged TriangleMesh or None, Materials) on `device`."""
    mesh, specs = load_glb_scene(path, device)
    return mesh, mat_mod.make_materials(specs, device)


def load_glb_scene(path: str, device="cuda"):
    """A .glb as (merged TriangleMesh or None, material spec dicts): the
    specs compose into an editable SceneGraph's material table."""
    with open(path, "rb") as f:
        magic, _version, _length = struct.unpack("<III", f.read(12))
        if magic != _GLB_MAGIC:
            raise ValueError(f"{path} is not a GLB file")
        gltf = None
        bin_blob = b""
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            clen, ctype = struct.unpack("<II", head)
            data = f.read(clen)
            if ctype == _CHUNK_JSON:
                gltf = json.loads(data)
            elif ctype == _CHUNK_BIN:
                bin_blob = data
    if gltf is None:
        raise ValueError(f"{path} has no JSON chunk")

    specs = []
    for m in gltf.get("materials", [{}]) or [{}]:
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])[:3]
        spec = dict(kind=mat_mod.MaterialKind.PBR, base_color=tuple(base),
                    metallic=pbr.get("metallicFactor", 1.0),
                    roughness=pbr.get("roughnessFactor", 1.0),
                    emissive=tuple(m.get("emissiveFactor", [0, 0, 0])))
        if "baseColorTexture" in pbr:
            tex = _decode_image(gltf, bin_blob,
                                pbr["baseColorTexture"]["index"])
            if tex is not None:
                spec["base_color_texture"] = tex
        if "normalTexture" in m:
            tex = _decode_image(gltf, bin_blob, m["normalTexture"]["index"])
            if tex is not None:
                spec["normal_texture"] = tex
        specs.append(spec)

    world = _node_transforms(gltf)
    parts = []
    for ni, nd in enumerate(gltf.get("nodes", [])):
        if "mesh" not in nd:
            continue
        W = world[ni]
        nrm_m = np.linalg.inv(W[:3, :3]).T
        for prim in gltf["meshes"][nd["mesh"]].get("primitives", []):
            attrs = prim["attributes"]
            pos = _read_accessor(gltf, bin_blob,
                                 attrs["POSITION"]).astype(np.float32)
            pos = pos @ W[:3, :3].T + W[:3, 3]
            nrm = None
            if "NORMAL" in attrs:
                nrm = _read_accessor(gltf, bin_blob,
                                     attrs["NORMAL"]).astype(np.float32)
                nrm = nrm @ nrm_m.T
                nrm /= np.maximum(
                    np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
            uv = None
            if "TEXCOORD_0" in attrs:
                uv = _read_accessor(gltf, bin_blob,
                                    attrs["TEXCOORD_0"]).astype(np.float32)
            if "indices" in prim:
                faces = _read_accessor(
                    gltf, bin_blob, prim["indices"]).reshape(-1, 3)
            else:
                faces = np.arange(pos.shape[0],
                                  dtype=np.int64).reshape(-1, 3)
            parts.append(mesh_mod.make_mesh(
                pos, faces.astype(np.int32),
                material_id=prim.get("material", 0), uvs=uv, normals=nrm,
                device=device))
    mesh = mesh_mod.merge_meshes(parts) if parts else None
    return mesh, specs
