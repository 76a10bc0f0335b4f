"""The per-view batch, the multi-view dataset interface, the shutter
metadata and the view-order stream, port of
threedgrut_tpu/datasets/protocols.py."""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Protocol, Tuple

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


class MultiViewDataset(Protocol):
    def __len__(self) -> int: ...
    def __getitem__(self, idx: int) -> View: ...
    @property
    def scene_extent(self) -> float: ...
    @property
    def observer_points(self) -> np.ndarray: ...


def parse_shutter(name) -> ShutterType:
    """Config string -> ShutterType ('global', 'rolling_top_to_bottom',
    ...); datasets stamp it onto every View."""
    if isinstance(name, ShutterType):
        return name
    return ShutterType[str(name).strip().upper()]


def parse_shutter_spec(spec):
    """Shutter config -> ShutterType OR {camera_id: ShutterType}: one name
    for every sensor ('rolling_top_to_bottom'), a mapping ({1: 'global',
    2: 'rolling_top_to_bottom'}) or the dotted-override string form
    '1:global,2:rolling_top_to_bottom'."""
    if isinstance(spec, dict):
        return {int(k): parse_shutter(v) for k, v in spec.items()}
    s = str(spec)
    if ":" in s:
        out = {}
        for part in s.split(","):
            cid, name = part.split(":")
            out[int(cid.strip())] = parse_shutter(name)
        return out
    return parse_shutter(s)


def shutter_for_camera(spec, camera_id: int) -> ShutterType:
    """A parse_shutter_spec result for one sensor (GLOBAL for camera ids
    the mapping does not name)."""
    if isinstance(spec, dict):
        return spec.get(int(camera_id), ShutterType.GLOBAL)
    return spec


def apply_shutter(view: View, shutter: ShutterType) -> View:
    """Stamp a shutter model on a view. COLMAP and NeRF formats carry no
    pose timestamps, so the end pose is the start pose; a dataset with real
    end poses sets `pose_end` itself."""
    if shutter == ShutterType.GLOBAL:
        return view
    view.shutter = shutter
    if view.pose_end is None:
        view.pose_end = view.T_to_world
    return view


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
