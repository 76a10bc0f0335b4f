"""COLMAP and ScanNet++ datasets: images + a sparse reconstruction ->
training views, port of threedgrut_tpu/datasets/dataset_colmap.py.

Reads `sparse/0` (bin or txt); SIMPLE_PINHOLE, PINHOLE, OPENCV and
OPENCV_FISHEYE cameras, one per sensor, into the port's PinholeCamera and
FisheyeCamera; downsampling from the `images_N` folders; the validation
split of every `test_split_interval`-th image (by name); the scene extent
from the camera bounding box; initialization points from points3D; and a
shutter per sensor. ScanNet++ is the same loader pointed at `colmap/` and
`undistorted_images/`.

`downsample_factor` N > 1 reads `images_N/` and scales the intrinsics by
1/N. Where `images_N/` is missing this raises FileNotFoundError naming it:
the JAX package then reads the full-size `images/` with the intrinsics
still scaled, and renders every view with the wrong camera (ROADMAP C10).
A decoded image whose size is not the camera's over N raises ValueError,
for the same reason.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from threedgrut_torch.cameras import FisheyeCamera, PinholeCamera
from threedgrut_torch.datasets import colmap
from threedgrut_torch.datasets.native_loader import ImageLoader, load_rgb
from threedgrut_torch.datasets.protocols import (View, apply_shutter,
                                                 camera_bbox_extent,
                                                 parse_shutter_spec,
                                                 shutter_for_camera)


def _camera_to_model(c: colmap.ColmapCamera, downsample: int):
    s = 1.0 / downsample
    p = c.params
    radial = np.zeros(6, np.float32)
    tangential = np.zeros(2, np.float32)
    if c.model == "SIMPLE_PINHOLE":
        f, cx, cy = p
        fx = fy = f
    elif c.model == "PINHOLE":
        fx, fy, cx, cy = p
    elif c.model == "OPENCV":
        fx, fy, cx, cy = p[:4]
        radial[0], radial[1] = p[4], p[5]
        tangential[0], tangential[1] = p[6], p[7]
    elif c.model == "OPENCV_FISHEYE":
        fx, fy, cx, cy = p[:4]
        return FisheyeCamera(
            focal=np.array([fx * s, fy * s], np.float32),
            principal=np.array([cx * s, cy * s], np.float32),
            radial=np.asarray(p[4:8], np.float32),
            max_angle=np.float32(np.pi / 2))
    else:
        raise ValueError(f"unsupported COLMAP camera model {c.model}")
    return PinholeCamera(
        focal=np.array([fx * s, fy * s], np.float32),
        principal=np.array([cx * s, cy * s], np.float32),
        radial=radial, tangential=tangential,
        thin_prism=np.zeros(4, np.float32))


class ColmapDataset:
    def __init__(self, path: str, split: str = "train",
                 downsample_factor: int = 1, test_split_interval: int = 8,
                 sparse_subdir: Optional[str] = None,
                 images_subdir: Optional[str] = None,
                 shutter_type="global"):
        self.path = path
        self.downsample = downsample_factor
        # One name, a {camera_id: name} dict or "1:global,2:rolling_...".
        self.shutter = parse_shutter_spec(shutter_type)
        sparse = sparse_subdir or self._find_sparse(path)
        cams, images, self.points, self.point_colors = colmap.load_sparse(
            os.path.join(path, sparse))
        self.cameras = {cid: _camera_to_model(c, downsample_factor)
                        for cid, c in cams.items()}
        self.raw_cameras = cams

        if images_subdir is None:
            images_subdir = ("images" if downsample_factor == 1
                             else f"images_{downsample_factor}")
            if not os.path.isdir(os.path.join(path, images_subdir)):
                raise FileNotFoundError(
                    f"{os.path.join(path, images_subdir)} not found: "
                    f"downsample_factor={downsample_factor} reads the "
                    f"images downsampled {downsample_factor}x from it")
        self.images_dir = os.path.join(path, images_subdir)

        ordered = sorted(images.values(), key=lambda im: im.name)
        if test_split_interval > 0:
            sel = [(i % test_split_interval == 0) for i in range(len(ordered))]
        else:
            sel = [False] * len(ordered)
        if split == "val":
            self.images = [im for im, v in zip(ordered, sel) if v]
        else:
            self.images = [im for im, v in zip(ordered, sel) if not v]

        self._poses = (np.stack([self._c2w(im) for im in self.images])
                       if self.images else np.zeros((0, 4, 4), np.float32))
        self._extent = (camera_bbox_extent(self._poses[:, :3, 3])
                        if len(self.images) else 1.0)
        self._cache: List[Optional[View]] = [None] * len(self.images)
        self._loader: Optional[ImageLoader] = None

    @staticmethod
    def _find_sparse(path: str) -> str:
        for cand in ("sparse/0", "sparse", "colmap/sparse/0", "colmap"):
            d = os.path.join(path, cand)
            if (os.path.exists(os.path.join(d, "cameras.bin"))
                    or os.path.exists(os.path.join(d, "cameras.txt"))):
                return cand
        raise FileNotFoundError(f"no COLMAP sparse model under {path}")

    @staticmethod
    def _c2w(im: colmap.ColmapImage) -> np.ndarray:
        R = colmap.qvec_to_rotmat(im.qvec)   # world->camera
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.T
        T[:3, 3] = (-R.T @ im.tvec).astype(np.float32)
        return T

    def __len__(self):
        return len(self.images)

    @property
    def scene_extent(self) -> float:
        return float(self._extent)

    @property
    def observer_points(self) -> np.ndarray:
        return self._poses[:, :3, 3]

    def initialization_points(self):
        """(xyz, rgb) from the sparse reconstruction, for model init."""
        return self.points, self.point_colors

    def __getitem__(self, idx: int) -> View:
        if self._cache[idx] is not None:
            return self._cache[idx]
        im = self.images[idx]
        if self._loader is None:
            self._loader = ImageLoader(n_threads=8)
        img_path = os.path.join(self.images_dir, im.name)
        img = load_rgb(self._loader, img_path)[..., :3]
        h, w = img.shape[:2]
        raw = self.raw_cameras[im.camera_id]
        if (abs(w * self.downsample - raw.width) >= self.downsample
                or abs(h * self.downsample - raw.height) >= self.downsample):
            raise ValueError(
                f"{img_path} is {w}x{h}, but camera {im.camera_id} "
                f"({raw.width}x{raw.height}) over downsample_factor "
                f"{self.downsample} is {raw.width / self.downsample:g}x"
                f"{raw.height / self.downsample:g}")
        view = apply_shutter(
            View(T_to_world=self._poses[idx],
                 camera=self.cameras[im.camera_id], resolution=(w, h),
                 rgb_gt=img),
            shutter_for_camera(self.shutter, im.camera_id))
        self._cache[idx] = view
        return view


class ScannetppDataset(ColmapDataset):
    """ScanNet++: the COLMAP model under `colmap/`, images under
    `undistorted_images/`."""

    def __init__(self, path: str, split: str = "train",
                 downsample_factor: int = 1, test_split_interval: int = 8,
                 shutter_type: str = "global"):
        super().__init__(path, split, downsample_factor, test_split_interval,
                         sparse_subdir="colmap",
                         images_subdir="undistorted_images",
                         shutter_type=shutter_type)
