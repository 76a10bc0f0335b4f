"""NeRF-synthetic (Blender) dataset: transforms_{split}.json + PNG frames,
port of threedgrut_tpu/datasets/dataset_nerf.py.

fov -> focal, the camera-to-world flip c2w[:3, 1:3] *= -1 (right-up-back ->
right-down-front), RGBA frames composited on `bg_color` (white by default),
an optional `<stem>_mask.png` beside a frame, scene extent = 1.1 x the
camera bounding-box diagonal, and the shutter stamp. Frames are decoded on
first access (native decoder or PIL, datasets/native_loader.py) and kept.

Unlike the JAX package (ROADMAP C9), the mask path is derived from the
frame's stem, so a frame that is not a PNG is never loaded as its own mask;
and the mask is downsampled with its frame.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from threedgrut_torch.cameras import PinholeCamera
from threedgrut_torch.datasets.native_loader import ImageLoader, load_rgb
from threedgrut_torch.datasets.protocols import (View, apply_shutter,
                                                 camera_bbox_extent,
                                                 parse_shutter)


def mask_path(frame_path: str) -> str:
    """`<stem>_mask.png` beside a frame, whatever the frame's extension."""
    return os.path.splitext(frame_path)[0] + "_mask.png"


class NeRFDataset:
    def __init__(self, path: str, split: str = "train",
                 downsample_factor: int = 1,
                 bg_color: Optional[np.ndarray] = None,
                 shutter_type: str = "global"):
        self.path = path
        self.split = split
        self.shutter = parse_shutter(shutter_type)
        with open(os.path.join(path, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        self.camera_angle_x = float(meta["camera_angle_x"])
        self.frames = meta["frames"]
        self.downsample = downsample_factor
        self.bg_color = (np.ones(3, np.float32) if bg_color is None
                         else np.asarray(bg_color, np.float32))
        self._views: List[Optional[View]] = [None] * len(self.frames)
        self._poses = np.stack([
            self._pose(np.asarray(fr["transform_matrix"], np.float32))
            for fr in self.frames])
        self._extent = camera_bbox_extent(self._poses[:, :3, 3])
        self._loader: Optional[ImageLoader] = None

    @staticmethod
    def _pose(c2w: np.ndarray) -> np.ndarray:
        out = c2w.copy()
        out[:3, 1:3] *= -1.0  # right-up-back -> right-down-front
        return out

    def __len__(self) -> int:
        return len(self.frames)

    @property
    def scene_extent(self) -> float:
        return self._extent

    @property
    def observer_points(self) -> np.ndarray:
        return self._poses[:, :3, 3]

    def _frame_path(self, fr) -> str:
        p = os.path.join(self.path, fr["file_path"])
        if not os.path.splitext(p)[1]:
            p += ".png"
        return p

    def _load(self, path: str) -> np.ndarray:
        if self._loader is None:
            self._loader = ImageLoader(n_threads=8)
        return load_rgb(self._loader, path)

    def __getitem__(self, idx: int) -> View:
        if self._views[idx] is not None:
            return self._views[idx]
        fr = self.frames[idx]
        frame = self._frame_path(fr)
        img = self._load(frame)
        if self.downsample > 1:
            img = img[::self.downsample, ::self.downsample]
        if img.shape[-1] == 4:
            alpha = img[..., 3:4]
            img = img[..., :3] * alpha + self.bg_color * (1.0 - alpha)
        h, w = img.shape[:2]
        focal = 0.5 * w / np.tan(0.5 * self.camera_angle_x)
        cam = PinholeCamera(
            focal=np.array([focal, focal], np.float32),
            principal=np.array([w / 2.0, h / 2.0], np.float32),
            radial=np.zeros(6, np.float32),
            tangential=np.zeros(2, np.float32),
            thin_prism=np.zeros(4, np.float32))
        mask = None
        mp = mask_path(frame)
        if os.path.exists(mp):
            mask = self._load(mp)[..., 0:1].astype(np.float32)
            if self.downsample > 1:
                mask = mask[::self.downsample, ::self.downsample]
        view = apply_shutter(
            View(T_to_world=self._poses[idx], camera=cam,
                 resolution=(w, h), rgb_gt=img.astype(np.float32),
                 mask=mask), self.shutter)
        self._views[idx] = view
        return view
