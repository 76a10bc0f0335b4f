"""Procedural in-memory dataset (no files needed), port of
threedgrut_tpu/datasets/dataset_synthetic.py: a ground-truth scene of random
Gaussians on an orbit of views, with ground truth rendered by the port's
fast renderer on `device` under each view's own camera, pose pair and
shutter. Training against it must recover the scene (PSNR rises).

`multi_sensor=True` builds the acceptance rig: alternating pinhole and
fisheye sensors, a top-to-bottom rolling shutter with a real end pose
(advanced along the orbit) on views i % 4 >= 2, and circular vignette masks
on the fisheye views.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from threedgrut_torch.cameras import (FisheyeCamera, PinholeCamera,
                                      SensorPose, ShutterType, look_at,
                                      pose_from_matrix)
from threedgrut_torch.datasets.protocols import View, camera_bbox_extent
from threedgrut_torch.device import resolve


def orbit_poses(n: int, radius: float = 4.0, height: float = 1.5,
                target=(0.0, 0.0, 0.0)) -> List[np.ndarray]:
    tgt = np.asarray(target, np.float32)
    poses = []
    for i in range(n):
        a = 2.0 * np.pi * i / n
        eye = np.array([radius * np.cos(a), radius * np.sin(a), height],
                       np.float32)
        poses.append(look_at(eye, tgt, np.array([0.0, 0.0, 1.0], np.float32)))
    return poses


def random_gt_scene(n: int, seed: int = 0, extent: float = 1.0):
    """Ground-truth particles (positions, unit quaternions, scales,
    opacities, SH degree-3 features), the JAX package's draws."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, extent / 2.0, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(0.12),
                                size=(n, 3))).astype(np.float32) * extent
    opac = rng.uniform(0.4, 0.95, size=(n,)).astype(np.float32)
    k = 16  # SH degree 3
    feats = np.zeros((n, k, 3), np.float32)
    feats[:, 0] = rng.uniform(-1.2, 1.2, size=(n, 3))
    feats[:, 1:] = rng.normal(0, 0.05, size=(n, k - 1, 3))
    return pos, quats, scales, opac, feats


class SyntheticDataset:
    def __init__(self, num_views: int = 12,
                 resolution: Tuple[int, int] = (64, 64),
                 num_gt_gaussians: int = 96, seed: int = 0,
                 sh_degree: int = 3, multi_sensor: bool = False,
                 device="cuda"):
        from threedgrut_torch.render import gut
        dev = resolve(device)
        self.resolution = resolution
        self.scene = random_gt_scene(num_gt_gaussians, seed)
        w, h = resolution
        f = 0.9 * w
        self.camera = PinholeCamera(
            focal=np.array([f, f], np.float32),
            principal=np.array([w / 2.0, h / 2.0], np.float32),
            radial=np.zeros(6, np.float32),
            tangential=np.zeros(2, np.float32),
            thin_prism=np.zeros(4, np.float32))
        fisheye = FisheyeCamera(
            focal=np.array([0.55 * w, 0.55 * w], np.float32),
            principal=np.array([w / 2.0, h / 2.0], np.float32),
            radial=np.array([0.03, 0.005, 0.0, 0.0], np.float32),
            max_angle=np.float32(1.2))
        self._poses = orbit_poses(num_views)
        # Rolling-shutter end poses: the camera goes on along the orbit
        # during the exposure (15% of the step between views).
        ang = 2.0 * np.pi * 0.15 / num_views
        rot = np.array([[np.cos(ang), -np.sin(ang), 0.0],
                        [np.sin(ang), np.cos(ang), 0.0],
                        [0.0, 0.0, 1.0]], np.float32)
        poses_end = []
        for T in self._poses:
            Te = T.copy()
            Te[:3, 3] = rot @ T[:3, 3]
            Te[:3, :3] = rot @ T[:3, :3]
            poses_end.append(Te)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        vignette = ((xx - w / 2.0) ** 2 + (yy - h / 2.0) ** 2
                    <= (0.62 * min(w, h)) ** 2).astype(np.float32)[..., None]

        gt_cap = max(1 << 16, min(1 << 22, 64 * num_gt_gaussians))
        gt_cap = -(-gt_cap // 256) * 256
        scene = [torch.as_tensor(x, device=dev) for x in self.scene]
        self._views = []
        for i, T in enumerate(self._poses):
            cam, shutter, pose_end, mask = (self.camera, ShutterType.GLOBAL,
                                            None, None)
            if multi_sensor:
                if i % 2 == 1:
                    cam, mask = fisheye, vignette
                if i % 4 >= 2:
                    shutter = ShutterType.ROLLING_TOP_TO_BOTTOM
                    pose_end = poses_end[i]
            p0 = pose_from_matrix(torch.as_tensor(T, device=dev))
            p1 = (p0 if pose_end is None else
                  pose_from_matrix(torch.as_tensor(pose_end, device=dev)))
            pose = SensorPose(q_start=p0.q_start, t_start=p0.t_start,
                              q_end=p1.q_start, t_end=p1.t_start)
            with torch.no_grad():
                out, ovf = gut.render(*scene, cam, pose, resolution, gt_cap,
                                      shutter=shutter, sh_degree=sh_degree,
                                      device=dev)
            if bool(ovf):
                raise RuntimeError("synthetic ground truth overflowed its "
                                   f"capacity {gt_cap}")
            rgb = np.clip(out.rgb.cpu().numpy(), 0.0, 1.0)
            self._views.append(View(T_to_world=T, camera=cam,
                                    resolution=resolution,
                                    rgb_gt=rgb.astype(np.float32), mask=mask,
                                    shutter=shutter, pose_end=pose_end))
        self._extent = camera_bbox_extent(
            np.stack([T[:3, 3] for T in self._poses]))

    def __len__(self):
        return len(self._views)

    def __getitem__(self, idx: int) -> View:
        return self._views[idx]

    @property
    def scene_extent(self) -> float:
        return self._extent

    @property
    def observer_points(self) -> np.ndarray:
        return np.stack([T[:3, 3] for T in self._poses])
