"""The per-view batch and the view-order stream, port of
threedgrut_tpu/datasets/protocols.py (the part the train step needs: View,
camera_bbox_extent, epoch_indices, iterate_epochs)."""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np

from threedgrut_torch.cameras import Camera, ShutterType


@dataclasses.dataclass
class View:
    """One training/eval view (host-side, numpy)."""
    T_to_world: np.ndarray          # [4, 4] camera-to-world (right-down-front)
    camera: Camera                  # pinhole or fisheye parameters
    resolution: Tuple[int, int]     # (W, H)
    rgb_gt: Optional[np.ndarray]    # [H, W, 3] float32 in [0, 1]
    mask: Optional[np.ndarray] = None   # [H, W, 1] float32
    shutter: ShutterType = ShutterType.GLOBAL
    pose_end: Optional[np.ndarray] = None  # [4, 4] for rolling shutter


def camera_bbox_extent(camera_centers: np.ndarray,
                       factor: float = 1.1) -> float:
    """Scene extent = factor * camera bounding-box diagonal."""
    lo = camera_centers.min(axis=0)
    hi = camera_centers.max(axis=0)
    return float(np.linalg.norm(hi - lo) * factor)


def epoch_indices(n: int, seed: int, epoch: int) -> np.ndarray:
    rng = np.random.default_rng(seed * 100003 + epoch)
    return rng.permutation(n)


def iterate_epochs(n: int, seed: int) -> Iterator[int]:
    """Infinite shuffled view-index stream, one permutation per epoch (the
    same order as the JAX package's for the same seed)."""
    epoch = 0
    while True:
        for i in epoch_indices(n, seed, epoch):
            yield int(i)
        epoch += 1
