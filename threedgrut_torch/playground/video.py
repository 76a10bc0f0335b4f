"""Camera-trajectory videos, port of threedgrut_tpu/playground/video.py:
orbit and keyframe trajectories (closed Catmull-Rom splines through the
camera positions, looking at a target) rendered with the Engine and
written as an MP4 where imageio and its ffmpeg backend import, else as
a PNG sequence.
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from threedgrut_torch.cameras import look_at

_UP = np.array([0, 0, 1], np.float32)


def catmull_rom(points: np.ndarray, n_samples: int) -> np.ndarray:
    """Closed-loop Catmull-Rom spline through [K, 3] control points."""
    k = len(points)
    out = []
    for i in range(n_samples):
        t = i / n_samples * k
        j = int(np.floor(t)) % k
        u = t - np.floor(t)
        p0, p1, p2, p3 = (points[(j - 1) % k], points[j],
                          points[(j + 1) % k], points[(j + 2) % k])
        out.append(0.5 * ((2 * p1) + (-p0 + p2) * u
                          + (2 * p0 - 5 * p1 + 4 * p2 - p3) * u * u
                          + (-p0 + 3 * p1 - 3 * p2 + p3) * u ** 3))
    return np.asarray(out, np.float32)


def orbit_trajectory(n_frames: int, radius: float = 4.0, height: float = 1.5,
                     target=(0, 0, 0)) -> List[np.ndarray]:
    """Camera-to-world matrices on a circle about +z, looking at
    `target`."""
    tgt = np.asarray(target, np.float32)
    Ts = []
    for i in range(n_frames):
        a = 2 * np.pi * i / n_frames
        eye = np.array([radius * np.cos(a), radius * np.sin(a), height],
                       np.float32)
        Ts.append(look_at(eye, tgt, _UP))
    return Ts


def keyframe_trajectory(keyframes: Sequence[np.ndarray], n_frames: int,
                        target=(0, 0, 0)) -> List[np.ndarray]:
    """`n_frames` cameras through the keyframes' positions, looking at
    `target`."""
    eyes = catmull_rom(np.asarray([T[:3, 3] for T in keyframes]), n_frames)
    tgt = np.asarray(target, np.float32)
    return [look_at(e, tgt, _UP) for e in eyes]


def mp4_writer():
    """imageio's v2 API where imageio and its ffmpeg backend
    (imageio_ffmpeg) import, else None: imageio alone has no MP4 writer."""
    try:
        import imageio.v2 as imageio
        import imageio_ffmpeg  # noqa: F401 (the MP4 backend)
    except ImportError:
        return None
    return imageio


def render_video(engine, cam, trajectory: List[np.ndarray],
                 resolution: Tuple[int, int], out_path: str,
                 fps: int = 30, hybrid: bool = False) -> str:
    """Render the trajectory (Engine.render_fitted: no truncated frame)
    and write it. Returns the path written: `out_path` as an MP4 where
    `mp4_writer` finds one, else the directory `<out_path without
    extension>` of frame_NNNN.png files. An encoder error raises."""
    frames = []
    for T in trajectory:
        out = engine.render_fitted(cam, T, resolution, hybrid=hybrid)
        frames.append((np.clip(out["rgb"].cpu().numpy(), 0, 1)
                       * 255).astype(np.uint8))
    imageio = mp4_writer()
    if imageio is not None:
        imageio.mimwrite(out_path, frames, fps=fps)
        return out_path
    from PIL import Image
    stem = os.path.splitext(out_path)[0]
    os.makedirs(stem, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(stem, f"frame_{i:04d}.png"))
    return stem
