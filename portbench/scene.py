"""The benchmark's inputs, made from --seed: particles shaped like a trained
scene (the configuration's mixture), the capture ring and its ground-truth
frames, and the fly-through path. The same seed gives the same inputs;
every seed gives the same views and path, so a seed changes the particles
and the ground truth but not the amount of work asked for.

Random numbers come from torch.Generators on the run's device, drawn in a
few large calls in float32, the type the particles are trained in.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.render import Camera

FIELDS = ("positions", "rotation", "scale", "density", "features_albedo",
          "features_specular", "alive")


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one named stream of a seed (seeds may exceed 32
    bits; streams never share state)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7919) % (1 << 63))
    return g


def round_capacity(n: int, granule: int = 4096) -> int:
    return max(granule, -(-n // granule) * granule)


def particles(cfg: dict, seed: int, device, n=None) -> Dict[str, torch.Tensor]:
    """Raw fields at the capacity rounded up to 4096 slots: positions,
    wxyz rotations, log scales, logit densities, SH degree-0 and higher
    coefficients, alive. Padding slots are dead (density -15, w = 1)."""
    mix = cfg["mixture"]
    n = n or cfg["particles"]
    cap = round_capacity(n)
    g = generator(seed, 1, device)
    f32 = dict(dtype=torch.float32, device=device)

    def u(*shape):
        return torch.rand(shape, generator=g, **f32)

    def nrm(*shape):
        return torch.randn(shape, generator=g, **f32)

    def log_uniform(lo, hi, k):
        return torch.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                         * u(k))

    n_obj = int(round(n * mix["object"]["share"]))
    n_gnd = int(round(n * mix["ground"]["share"]))
    n_bg = n - n_obj - n_gnd
    o, gd, bg = mix["object"], mix["ground"], mix["background"]
    pos_obj = (torch.tensor(o["center"], **f32)
               + nrm(n_obj, 3) * torch.tensor(o["sigma"], **f32))
    r = gd["radius"] * torch.sqrt(u(n_gnd))
    th = 2 * math.pi * u(n_gnd)
    pos_gnd = torch.stack([r * torch.cos(th), r * torch.sin(th),
                           gd["z"] + gd["z_sigma"] * nrm(n_gnd)], -1)
    d = nrm(n_bg, 3)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    d[:, 2] = bg["z_min"] + (1 - bg["z_min"]) * d[:, 2].abs()
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    dist = bg["radius"][0] + (bg["radius"][1] - bg["radius"][0]) * u(n_bg)
    pos_bg = d * dist[:, None]
    base = torch.cat([log_uniform(*o["scale"], n_obj),
                      log_uniform(*gd["scale"], n_gnd),
                      dist * log_uniform(*bg["scale_of_distance"], n_bg)])
    aniso = torch.exp(math.log(mix["anisotropy"][0]) * u(n, 3))
    aniso[:, 0] = 1.0
    scales = base[:, None] * aniso
    # Opacity: a mixture of uniform bands [share, lo, hi].
    bands = torch.tensor(mix["opacity"], **f32)
    which = torch.multinomial(bands[:, 0], n, replacement=True, generator=g)
    lo, hi = bands[which, 1], bands[which, 2]
    opacity = lo + (hi - lo) * u(n)
    k = (cfg["sh_degree"] + 1) ** 2 - 1

    out = dict(
        positions=torch.cat([pos_obj, pos_gnd, pos_bg]),
        rotation=nrm(n, 4),
        scale=torch.log(scales),
        density=torch.log(opacity / (1 - opacity))[:, None],
        features_albedo=mix["albedo_sigma"] * nrm(n, 3),
        features_specular=mix["specular_sigma"] * nrm(n, 3 * k),
        alive=torch.ones(n, dtype=torch.bool, device=device))
    pad = cap - n
    fill = dict(positions=0.0, rotation=0.0, scale=0.0, density=-15.0,
                features_albedo=0.0, features_specular=0.0, alive=False)
    for f in FIELDS:
        x = out[f]
        tail = torch.full((pad,) + x.shape[1:], fill[f], dtype=x.dtype,
                          device=device)
        if f == "rotation":
            tail[:, 0] = 1.0
        out[f] = torch.cat([x, tail])
    return out


def look_at(eye, target, up) -> np.ndarray:
    """Camera-to-world 4x4 with right-down-front axes."""
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
    return T.astype(np.float32)


def ring_poses(cfg: dict) -> List[np.ndarray]:
    """The training views' camera-to-world matrices: the ring's captures
    with every test_split_interval-th held out."""
    s = cfg["scene"]
    poses = []
    for i in range(s["captures"]):
        if i % s["test_split_interval"] == 0:
            continue
        th = 2 * math.pi * i / s["captures"]
        r = s["ring_radius"] + s["ring_radius_wobble"] * math.cos(3 * th)
        h = s["ring_height"] + s["ring_height_wobble"] * math.sin(2 * th)
        eye = np.array([r * math.cos(th), r * math.sin(th), h])
        poses.append(look_at(eye, s["look_at"], s["up"]))
    if len(poses) != s["train_views"]:
        raise ValueError(f"{len(poses)} training views, the configuration "
                         f"says {s['train_views']}")
    return poses


def path_poses(cfg: dict, traffic: dict, n: int) -> List[np.ndarray]:
    """n fly-through poses: an orbit of deg_per_frame degrees a frame with
    a slow rise and fall, looking at the scene's centre."""
    s = cfg["scene"]
    out = []
    for k in range(n):
        th = math.radians(traffic["deg_per_frame"] * k)
        h = traffic["path_height"] + traffic["path_height_wobble"] \
            * math.sin(th / 2)
        eye = np.array([traffic["path_radius"] * math.cos(th),
                        traffic["path_radius"] * math.sin(th), h])
        out.append(look_at(eye, s["look_at"], s["up"]))
    return out


def camera(cfg: dict, c2w: np.ndarray, device, width=None,
           height=None) -> Camera:
    """The reference's camera for a pose; a width other than the
    configuration's keeps its field of view."""
    s = cfg["scene"]
    w, h = width or s["width"], height or s["height"]
    f = s["focal"] * w / s["width"]
    return Camera(f, f, w / 2.0, h / 2.0, w, h,
                  torch.tensor(c2w, dtype=torch.float32, device=device))


def ground_truth(cfg: dict, seed: int, n_views: int, device,
                 batch: int = 16) -> List[np.ndarray]:
    """One smooth colour field a view, [H, W, 3] float32 in [0, 1], held
    in host memory as a dataset's cache holds decoded frames."""
    s = cfg["scene"]
    h, w = s["height"], s["width"]
    g = generator(seed, 2, device)
    out = []
    for b in range(0, n_views, batch):
        k = min(batch, n_views - b)
        low = torch.rand((k, 3, 12, 18), generator=g, device=device)
        img = torch.nn.functional.interpolate(low, size=(h, w),
                                              mode="bicubic",
                                              align_corners=False)
        img = img + 0.03 * torch.randn((k, 3, h, w), generator=g,
                                       device=device)
        img = img.clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous().cpu()
        out.extend(np.ascontiguousarray(x) for x in img.numpy())
    return out


def scene_extent(poses) -> float:
    """1.1 x the diagonal of the training cameras' bounding box (the
    trainer's scene extent for a COLMAP scene)."""
    c = np.stack([T[:3, 3] for T in poses])
    return float(np.linalg.norm(c.max(0) - c.min(0)) * 1.1)
