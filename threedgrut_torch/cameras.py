"""Camera models, port of threedgrut_tpu/cameras.py.

OpenCV pinhole (rational radial + tangential + thin-prism) and OpenCV fisheye
(theta polynomial), rolling-shutter pose interpolation, and ray generation
(forward projection and Newton-inverted fisheye rays). Camera and pose
containers are NamedTuples of tensors; resolutions are Python ints.
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from threedgrut_torch.device import resolve
from threedgrut_torch.ops import quaternion


class ShutterType(enum.IntEnum):
    GLOBAL = 0
    ROLLING_TOP_TO_BOTTOM = 1
    ROLLING_LEFT_TO_RIGHT = 2
    ROLLING_BOTTOM_TO_TOP = 3
    ROLLING_RIGHT_TO_LEFT = 4


class PinholeCamera(NamedTuple):
    """OpenCV pinhole camera; zero distortion coefficients are ideal."""
    focal: torch.Tensor          # [2] fx, fy
    principal: torch.Tensor      # [2] cx, cy
    radial: torch.Tensor         # [6] k1..k6 (rational model)
    tangential: torch.Tensor     # [2] p1, p2
    thin_prism: torch.Tensor     # [4] s1..s4


class FisheyeCamera(NamedTuple):
    """OpenCV fisheye: r(theta) = theta (1 + k1 t^2 + k2 t^4 + k3 t^6 + k4 t^8)."""
    focal: torch.Tensor          # [2]
    principal: torch.Tensor      # [2]
    radial: torch.Tensor         # [4] k1..k4
    max_angle: torch.Tensor      # [] radians


Camera = Union[PinholeCamera, FisheyeCamera]


class SensorPose(NamedTuple):
    """World->camera pose pair for shutter interpolation; x_cam = R(q) x + t.
    Global-shutter cameras have start == end."""
    q_start: torch.Tensor  # [4]
    t_start: torch.Tensor  # [3]
    q_end: torch.Tensor    # [4]
    t_end: torch.Tensor    # [3]


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Camera-to-world 4x4 with right-down-front (OpenCV) axes."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4, dtype=np.float32)
    T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = right, down, fwd, eye
    return T


def pose_from_matrix(T_to_world: torch.Tensor) -> SensorPose:
    """Static SensorPose from a camera-to-world 4x4 matrix."""
    R_c2w = T_to_world[:3, :3]
    t_c2w = T_to_world[:3, 3]
    R_w2c = R_c2w.T
    t_w2c = -R_w2c @ t_c2w
    q = matrix_to_quat(R_w2c)
    return SensorPose(q_start=q, t_start=t_w2c, q_end=q, t_end=t_w2c)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> wxyz quaternion (Shepperd: the best of four)."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22])
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) * 0.5
    case0 = torch.stack([qw[0], (m21 - m12) / (4 * qw[0]),
                         (m02 - m20) / (4 * qw[0]), (m10 - m01) / (4 * qw[0])])
    case1 = torch.stack([(m21 - m12) / (4 * qw[1]), qw[1],
                         (m01 + m10) / (4 * qw[1]), (m02 + m20) / (4 * qw[1])])
    case2 = torch.stack([(m02 - m20) / (4 * qw[2]), (m01 + m10) / (4 * qw[2]),
                         qw[2], (m12 + m21) / (4 * qw[2])])
    case3 = torch.stack([(m10 - m01) / (4 * qw[3]), (m02 + m20) / (4 * qw[3]),
                         (m12 + m21) / (4 * qw[3]), qw[3]])
    idx = torch.argmax(torch.stack([tr, m00, m11, m22]))
    q = torch.stack([case0, case1, case2, case3])[idx]
    return quaternion.normalize(q)


# ---------------------------------------------------------------------------
# Forward projection (camera-space position -> pixel)
# ---------------------------------------------------------------------------

def _within_resolution(resolution: Tuple[int, int], tolerance: float,
                       p: torch.Tensor) -> torch.Tensor:
    w, h = float(resolution[0]), float(resolution[1])
    mx, my = w * tolerance, h * tolerance
    return ((p[..., 0] > -mx) & (p[..., 1] > -my)
            & (p[..., 0] < w + mx) & (p[..., 1] < h + my))


def project_point_pinhole(cam: PinholeCamera, resolution: Tuple[int, int],
                          position: torch.Tensor, tolerance: float):
    """Camera-space points [..., 3] -> (uv [..., 2], valid [...]), with the
    reference's out-of-limits radial fallback and z <= 0 -> (0, 0)."""
    z = position[..., 2]
    safe_z = torch.where(z > 0.0, z, torch.ones_like(z))
    uvn = position[..., :2] / safe_z[..., None]
    uvsq = uvn * uvn
    r2 = uvsq[..., 0] + uvsq[..., 1]
    a1 = 2.0 * uvn[..., 0] * uvn[..., 1]
    a2 = r2 + 2.0 * uvsq[..., 0]
    a3 = r2 + 2.0 * uvsq[..., 1]
    k = cam.radial
    icd_num = 1.0 + r2 * (k[0] + r2 * (k[1] + r2 * k[2]))
    icd_den = 1.0 + r2 * (k[3] + r2 * (k[4] + r2 * k[5]))
    icd = icd_num / icd_den
    p1, p2 = cam.tangential[0], cam.tangential[1]
    s = cam.thin_prism
    delta = torch.stack([
        p1 * a1 + p2 * a2 + r2 * (s[0] + r2 * s[1]),
        p1 * a3 + p2 * a1 + r2 * (s[2] + r2 * s[3]),
    ], dim=-1)
    uv_nd = icd[..., None] * uvn + delta
    valid_radial = (icd > 0.8) & (icd < 1.2)
    projected_ok = uv_nd * cam.focal + cam.principal
    roi_radius = float(np.hypot(resolution[0], resolution[1]))
    safe_r = torch.sqrt(torch.clamp(r2, min=1e-24))
    projected_bad = (roi_radius / safe_r)[..., None] * uvn + cam.principal
    projected = torch.where(valid_radial[..., None], projected_ok,
                            projected_bad)
    projected = torch.where((z > 0.0)[..., None], projected,
                            torch.zeros_like(projected))
    valid = ((z > 0.0) & valid_radial
             & _within_resolution(resolution, tolerance, projected))
    return projected, valid


def project_point_fisheye(cam: FisheyeCamera, resolution: Tuple[int, int],
                          position: torch.Tensor, tolerance: float):
    """Camera-space points through the fisheye theta polynomial."""
    eps = torch.finfo(torch.float32).eps
    rho = torch.clamp(
        torch.sqrt(position[..., 0] ** 2 + position[..., 1] ** 2), min=eps)
    theta_full = torch.atan2(rho, position[..., 2])
    theta = torch.minimum(theta_full, cam.max_angle)
    t2 = theta * theta
    k = cam.radial
    poly = ((((k[3]) * t2 + k[2]) * t2 + k[1]) * t2 + k[0])
    delta = theta * (poly * t2 + 1.0) / rho
    projected = cam.focal * position[..., :2] * delta[..., None] + cam.principal
    valid = (theta_full < cam.max_angle) & _within_resolution(
        resolution, tolerance, projected)
    return projected, valid


def project_point(cam: Camera, resolution: Tuple[int, int],
                  position: torch.Tensor, tolerance: float):
    if isinstance(cam, PinholeCamera):
        return project_point_pinhole(cam, resolution, position, tolerance)
    if isinstance(cam, FisheyeCamera):
        return project_point_fisheye(cam, resolution, position, tolerance)
    raise TypeError(f"unknown camera type {type(cam)}")


def relative_shutter_time(shutter: ShutterType, resolution: Tuple[int, int],
                          position: torch.Tensor) -> torch.Tensor:
    w, h = float(resolution[0]), float(resolution[1])
    x, y = position[..., 0], position[..., 1]
    if shutter == ShutterType.ROLLING_TOP_TO_BOTTOM:
        return torch.floor(y) / (h - 1.0)
    if shutter == ShutterType.ROLLING_LEFT_TO_RIGHT:
        return torch.floor(x) / (w - 1.0)
    if shutter == ShutterType.ROLLING_BOTTOM_TO_TOP:
        return (h - torch.ceil(y)) / (h - 1.0)
    if shutter == ShutterType.ROLLING_RIGHT_TO_LEFT:
        return (w - torch.ceil(x)) / (w - 1.0)
    return torch.full(position.shape[:-1], 0.5, dtype=position.dtype,
                      device=position.device)


def transform_to_camera(pose_q: torch.Tensor, pose_t: torch.Tensor,
                        position: torch.Tensor) -> torch.Tensor:
    return quaternion.rotate(pose_q, position) + pose_t


def project_point_with_shutter(cam: Camera, pose: SensorPose,
                               shutter: ShutterType,
                               resolution: Tuple[int, int],
                               position: torch.Tensor, tolerance: float,
                               n_iterations: int = 5):
    """World points -> pixels with the rolling-shutter fixed-point iteration
    (start pose, end pose if invalid, then `n_iterations` refinements)."""
    proj, valid = project_point(
        cam, resolution,
        transform_to_camera(pose.q_start, pose.t_start, position), tolerance)
    if shutter == ShutterType.GLOBAL:
        return proj, valid
    proj_end, valid_end = project_point(
        cam, resolution,
        transform_to_camera(pose.q_end, pose.t_end, position), tolerance)
    proj = torch.where(valid[..., None], proj, proj_end)
    any_valid = valid | valid_end
    for _ in range(n_iterations):
        alpha = relative_shutter_time(shutter, resolution, proj)
        q = quaternion.slerp(pose.q_start, pose.q_end, alpha[..., None])
        t = (pose.t_start * (1.0 - alpha[..., None])
             + pose.t_end * alpha[..., None])
        cam_pos = quaternion.rotate(q, position) + t
        proj, valid = project_point(cam, resolution, cam_pos, tolerance)
    return proj, valid & any_valid


# ---------------------------------------------------------------------------
# Ray generation (pixel -> camera-space ray)
# ---------------------------------------------------------------------------

def pinhole_camera_rays(cam: PinholeCamera, resolution: Tuple[int, int],
                        jitter: torch.Tensor | None = None):
    """Per-pixel camera-space rays (origins [H, W, 3] zeros, unit dirs),
    pixel centres at +0.5 unless `jitter` [H, W, 2] gives the offsets."""
    w, h = resolution
    dev = cam.focal.device
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    if jitter is None:
        jx = jy = 0.5
    else:
        jx, jy = jitter[..., 0], jitter[..., 1]
    u = (gx + jx - cam.principal[0]) / cam.focal[0]
    v = (gy + jy - cam.principal[1]) / cam.focal[1]
    d = torch.stack([u, v, torch.ones_like(u)], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.zeros_like(d), d


def fisheye_camera_rays(cam: FisheyeCamera, resolution: Tuple[int, int],
                        newton_iterations: int = 10):
    """Per-pixel fisheye rays by Newton inversion of the theta polynomial."""
    w, h = resolution
    dev = cam.focal.device
    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    ys = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    mx = (gx - cam.principal[0]) / cam.focal[0]
    my = (gy - cam.principal[1]) / cam.focal[1]
    r_d = torch.sqrt(mx * mx + my * my)
    k = cam.radial

    def f(theta):
        t2 = theta * theta
        return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2]
                                                              + t2 * k[3]))))

    def fprime(theta):
        t2 = theta * theta
        return (1.0 + t2 * (3.0 * k[0] + t2 * (5.0 * k[1] + t2 * (7.0 * k[2]
                + t2 * 9.0 * k[3]))))

    theta = r_d
    for _ in range(newton_iterations):
        theta = theta - (f(theta) - r_d) / torch.clamp(fprime(theta), min=1e-6)
    theta = torch.clamp(theta, min=0.0)
    safe_r = torch.clamp(r_d, min=1e-9)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    d = torch.stack([sin_t * mx / safe_r, sin_t * my / safe_r, cos_t], dim=-1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.zeros_like(d), d


def example_camera(resolution: Tuple[int, int],
                   device="cuda") -> PinholeCamera:
    """Ideal pinhole with focal 0.9 * width, centred principal point, on
    `device` (the card unless the caller asks for the CPU)."""
    w, h = resolution
    f = 0.9 * w
    device = resolve(device)

    def t(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return PinholeCamera(focal=t([f, f]), principal=t([w / 2, h / 2]),
                         radial=t([0.0] * 6), tangential=t([0.0] * 2),
                         thin_prism=t([0.0] * 4))

