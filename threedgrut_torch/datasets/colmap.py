"""COLMAP sparse-reconstruction parsers and writers (cameras / images /
points3D, binary and text), the port's own copy of
threedgrut_tpu/datasets/colmap.py (numpy only)."""
from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np

CAMERA_MODEL_PARAMS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),           # fx fy cx cy k1 k2 p1 p2
    5: ("OPENCV_FISHEYE", 8),   # fx fy cx cy k1 k2 k3 k4
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME_TO_ID = {v[0]: k for k, v in CAMERA_MODEL_PARAMS.items()}


class ColmapCamera(NamedTuple):
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    qvec: np.ndarray   # [4] wxyz world->camera rotation
    tvec: np.ndarray   # [3]
    camera_id: int
    name: str


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_ = CAMERA_MODEL_PARAMS[model_id]
            params = np.frombuffer(f.read(8 * np_), dtype="<f8")
            cams[cid] = ColmapCamera(name, int(w), int(h),
                                     params.astype(np.float64))
    return cams


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            t = line.split()
            cid, model, w, h = int(t[0]), t[1], int(t[2]), int(t[3])
            params = np.array([float(x) for x in t[4:]], np.float64)
            cams[cid] = ColmapCamera(model, w, h, params)
    return cams


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            q = struct.unpack("<dddd", f.read(32))
            t = struct.unpack("<ddd", f.read(24))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            n2d = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n2d)  # skip 2D points
            images[iid] = ColmapImage(np.array(q), np.array(t), cam_id,
                                      name.decode("utf-8"))
    return images


def read_images_txt(path: str) -> Dict[int, ColmapImage]:
    """Two lines per image: its pose, camera and name, then its 2D points,
    a line that is empty for an image without any. (The JAX package drops
    empty lines before pairing them, which misreads every image after one
    without 2D points: ROADMAP C12.)"""
    images = {}
    with open(path) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        t = lines[i].split()
        iid = int(t[0])
        q = np.array([float(x) for x in t[1:5]])
        tv = np.array([float(x) for x in t[5:8]])
        images[iid] = ColmapImage(q, tv, int(t[8]), t[9])
        i += 2
    return images


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    xyz, rgb = [], []
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            f.read(8)  # point id
            xyz.append(struct.unpack("<ddd", f.read(24)))
            rgb.append(struct.unpack("<BBB", f.read(3)))
            f.read(8)  # error
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.read(8 * track_len)
    return (np.asarray(xyz, np.float32),
            np.asarray(rgb, np.float32) / 255.0)


def read_points3d_txt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    xyz, rgb = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            t = line.split()
            xyz.append([float(x) for x in t[1:4]])
            rgb.append([float(x) for x in t[4:7]])
    return (np.asarray(xyz, np.float32),
            np.asarray(rgb, np.float32) / 255.0)


def write_cameras_bin(path: str, cams: Dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, c in cams.items():
            f.write(struct.pack("<iiQQ", cid, _NAME_TO_ID[c.model],
                                c.width, c.height))
            f.write(np.asarray(c.params, "<f8").tobytes())


def write_images_bin(path: str, images: Dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, im in images.items():
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_bin(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<ddd", *xyz[i].astype(np.float64)))
            f.write(struct.pack("<BBB",
                                *(rgb[i] * 255).astype(np.uint8)))
            f.write(struct.pack("<d", 1.0))
            f.write(struct.pack("<Q", 0))


def load_sparse(sparse_dir: str):
    """Load cameras/images/points from sparse dir (bin preferred)."""
    def pick(stem, bin_reader, txt_reader):
        b = os.path.join(sparse_dir, stem + ".bin")
        t = os.path.join(sparse_dir, stem + ".txt")
        if os.path.exists(b):
            return bin_reader(b)
        if os.path.exists(t):
            return txt_reader(t)
        raise FileNotFoundError(f"{stem}.bin/.txt not found in {sparse_dir}")

    cams = pick("cameras", read_cameras_bin, read_cameras_txt)
    images = pick("images", read_images_bin, read_images_txt)
    try:
        points, colors = pick("points3D", read_points3d_bin,
                              read_points3d_txt)
    except FileNotFoundError:
        points, colors = (np.zeros((0, 3), np.float32),
                          np.zeros((0, 3), np.float32))
    return cams, images, points, colors


def qvec_to_rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
