"""The playground cell's scene graph, made by the benchmark: a mirror floor
quad, a glass icosphere, a textured and normal-mapped PBR card and an
equirect sky, as numpy arrays from the configuration and the seed. Both
the program and the reference are handed these arrays; each works out its
own normals, tangents and material tables from them.
"""
from __future__ import annotations

import math

import numpy as np


def quad(center, u, v, uv_scale=1.0):
    c, u, v = (np.asarray(x, np.float32) for x in (center, u, v))
    verts = np.stack([c - u - v, c + u - v, c + u + v, c - u + v])
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    return verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32), uvs


def icosphere(center, radius, subdivisions):
    """An icosahedron subdivided `subdivisions` times (20 x 4^k faces),
    its vertices pushed out to the sphere."""
    phi = (1 + 5 ** 0.5) / 2
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in (
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1])]
    faces = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
             [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
             [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
             [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(subdivisions):
        mid, out = {}, []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = (verts[a] + verts[b]) / 2
                mid[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = out
    v = np.asarray(verts, np.float32) * radius + np.asarray(center,
                                                            np.float32)
    return (v, np.asarray(faces, np.int32),
            np.zeros((v.shape[0], 2), np.float32))


def meshes(cfg):
    """[(vertices, faces, uvs, material id)] of the scene graph."""
    out = []
    for m in cfg["meshes"]:
        if m["kind"] == "quad":
            v, f, uv = quad(m["center"], m["u"], m["v"],
                            m.get("uv_scale", 1.0))
        else:
            v, f, uv = icosphere(m["center"], m["radius"],
                                 m["subdivisions"])
        out.append((v, f, uv, m["material"]))
    return out


def textures(seed: int):
    """The card's base colour (a 16x16 checker) and tangent-space normal
    map (8x8, tilted from the seed), in [0, 1]."""
    rng = np.random.default_rng(int(seed))
    checker = ((np.indices((16, 16)).sum(0) // 4) % 2).astype(np.float32)
    colour = np.stack([checker * 200 + 40, np.full_like(checker, 60),
                       240 - checker * 180], -1) / 255.0
    normal = np.clip(np.stack([128 + rng.integers(-40, 40, (8, 8)),
                               128 + rng.integers(-40, 40, (8, 8)),
                               np.full((8, 8), 230)], -1), 0, 255) / 255.0
    return colour.astype(np.float32), normal.astype(np.float32)


def material_specs(cfg, seed: int):
    """Material spec dicts (threedgrut_torch.playground.materials'
    make_materials format); "textured" ones take the card's textures."""
    colour, normal = textures(seed)
    out = []
    for m in cfg["materials"]:
        s = {k: v for k, v in m.items() if k != "textured"}
        if m.get("textured"):
            s["base_color_texture"] = colour
            s["normal_texture"] = normal
        out.append(s)
    return out


def sky(h: int, w: int) -> np.ndarray:
    """An equirect sky [h, w, 3]: blue above the horizon, brown below, a
    sun of radiance ~4 (polar angle from +z)."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = ((np.arange(w) + 0.5) / w - 0.5) * 2 * np.pi
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    up = np.clip(np.cos(th), 0, 1)[..., None]
    air = (1 - up) * np.array([0.8, 0.85, 0.9]) + up * np.array(
        [0.25, 0.45, 0.9])
    env = np.where((th < np.pi / 2)[..., None], air,
                   np.array([0.35, 0.28, 0.2]))
    sun = np.exp(-((th - 0.6) ** 2 + (ph - 1.0) ** 2) / 0.01)[..., None]
    return (env + 4.0 * sun).astype(np.float32)


def orbit_pose(traffic, k: int):
    """Camera-to-world of orbit frame k (right-down-front axes)."""
    from portbench.scene import look_at
    th = math.radians(traffic["start_deg"] + traffic["deg_per_frame"] * k)
    eye = np.array([traffic["path_radius"] * math.cos(th),
                    traffic["path_radius"] * math.sin(th),
                    traffic["path_height"]])
    return look_at(eye, traffic["look_at"], [0.0, 0.0, 1.0])
