"""Gaussian particle parameters as an nn.Module, port of
threedgrut_tpu/model/gaussians.py.

The six raw (pre-activation) fields are nn.Parameters padded to a capacity,
and `alive` is a buffer; dead or padding particles get opacity exactly 0, so
the alpha threshold culls them. Activations match the reference: normalized
quaternions, exp scales, sigmoid density times the alive mask.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from threedgrut_torch.constants import SH_C0
from threedgrut_torch.device import resolve
from threedgrut_torch.ops import quaternion

# The raw fields in the JAX package's order (its Gaussians dataclass).
FIELDS = ("positions", "rotation", "scale", "density", "features_albedo",
          "features_specular", "alive")


def sh_degree_to_num_coeffs(deg: int) -> int:
    return (deg + 1) ** 2


def sh_degree_to_specular_dim(deg: int) -> int:
    return (sh_degree_to_num_coeffs(deg) - 1) * 3


class Gaussians(nn.Module):
    """Raw parameters, all with leading dim = capacity.

    positions [C, 3], rotation [C, 4] unnormalized wxyz, scale [C, 3] log,
    density [C, 1] pre-sigmoid, features_albedo [C, 3] SH degree 0,
    features_specular [C, (K-1)*3] higher SH ([coeff, channel] layout),
    alive [C] bool buffer.
    """

    def __init__(self, positions, rotation, scale, density, features_albedo,
                 features_specular, alive):
        super().__init__()
        self.positions = nn.Parameter(positions)
        self.rotation = nn.Parameter(rotation)
        self.scale = nn.Parameter(scale)
        self.density = nn.Parameter(density)
        self.features_albedo = nn.Parameter(features_albedo)
        self.features_specular = nn.Parameter(features_specular)
        self.register_buffer("alive", alive)

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @property
    def max_sh_degree(self) -> int:
        k = self.features_specular.shape[1] // 3 + 1
        deg = int(np.sqrt(k)) - 1
        if (deg + 1) ** 2 != k:
            raise ValueError(
                f"bad specular dim {tuple(self.features_specular.shape)}")
        return deg

    def num_active(self) -> torch.Tensor:
        return self.alive.sum()

    # ---- activations (reference model.py:163-167) ----
    def get_positions(self) -> torch.Tensor:
        return self.positions

    def get_rotation(self) -> torch.Tensor:
        return quaternion.normalize(self.rotation)

    def get_scale(self) -> torch.Tensor:
        return torch.exp(self.scale)

    def get_density(self) -> torch.Tensor:
        """Post-activation opacity [C]; exactly 0 for dead particles."""
        return torch.sigmoid(self.density[:, 0]) * self.alive.to(
            self.density.dtype)

    def get_features(self) -> torch.Tensor:
        """All SH coefficients as [C, K, 3]."""
        spec = self.features_specular.reshape(self.capacity, -1, 3)
        return torch.cat([self.features_albedo[:, None, :], spec], dim=1)


def from_numpy(fields: Dict[str, np.ndarray], device="cuda") -> Gaussians:
    """The JAX Gaussians' seven raw fields (as numpy arrays, capacity
    padding included) -> the port's module on `device`. The optimizer state
    that goes with them comes from optimizers.state_from_numpy."""
    dev = resolve(device)
    missing = [f for f in FIELDS if f not in fields]
    if missing:
        raise KeyError(f"missing Gaussians fields {missing}")
    # Copies (torch.tensor): the optimizer updates parameters in place, and
    # must not write through to the caller's arrays.
    t = {f: torch.tensor(np.asarray(fields[f], dtype=np.float32),
                         device=dev)
         for f in FIELDS if f != "alive"}
    alive = torch.tensor(np.asarray(fields["alive"], dtype=bool), device=dev)
    return Gaussians(alive=alive, **t)


def _pad(arr: np.ndarray, capacity: int, fill: float = 0.0) -> np.ndarray:
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(f"{n} particles exceed capacity {capacity}")
    out = np.full((capacity,) + arr.shape[1:], fill, dtype=np.float32)
    out[:n] = arr
    return out


def round_capacity(n: int, granule: int = 4096) -> int:
    return max(granule, -(-n // granule) * granule)


def inverse_sigmoid(x):
    return np.log(x / (1.0 - x))


def padded_fields(positions, rotation, scale, density, features_albedo,
                  features_specular,
                  capacity: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Raw numpy fields padded to `capacity` exactly as the JAX
    `from_arrays` pads them (w=1 rotations, density -15, alive mask)."""
    n = positions.shape[0]
    cap = capacity or round_capacity(n)
    alive = np.zeros(cap, bool)
    alive[:n] = True
    rot = _pad(rotation, cap)
    rot[n:, 0] = 1.0
    return dict(positions=_pad(positions, cap), rotation=rot,
                scale=_pad(scale, cap),
                density=_pad(density, cap, fill=-15.0),
                features_albedo=_pad(features_albedo, cap),
                features_specular=_pad(features_specular, cap), alive=alive)


def from_arrays(positions, rotation, scale, density, features_albedo,
                features_specular, capacity: Optional[int] = None,
                device="cuda") -> Gaussians:
    return from_numpy(padded_fields(positions, rotation, scale, density,
                                    features_albedo, features_specular,
                                    capacity), device)


def init_random(num_gaussians: int, max_sh_degree: int = 3,
                xyz_min: float = -1.5, xyz_max: float = 1.5,
                default_density: float = 0.1,
                default_scale_factor: float = 1.0, seed: int = 0,
                capacity: Optional[int] = None, device="cuda") -> Gaussians:
    """Random point cloud in a box (reference model.py:368-436): uniform
    positions, albedo in [0, 1/255], scale from the 1-NN distance, w=1
    rotations. Numbers come from numpy's generator seeded with `seed`, so
    they equal the JAX package's for the same seed."""
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(seed)
    pts = rng.uniform(xyz_min, xyz_max,
                      size=(num_gaussians, 3)).astype(np.float32)
    color = rng.uniform(0, 1.0 / 255.0,
                        size=(num_gaussians, 3)).astype(np.float32)
    d, _ = cKDTree(pts).query(pts, k=2)
    dist = np.maximum(d[:, 1].astype(np.float32), 1e-3)
    scales = np.log(dist * default_scale_factor)[:, None].repeat(3, 1)
    rots = rng.uniform(0, 1, size=(num_gaussians, 4)).astype(np.float32)
    rots[:, 0] = 1.0
    density = np.full((num_gaussians, 1), inverse_sigmoid(default_density),
                      np.float32)
    spec = np.zeros((num_gaussians, sh_degree_to_specular_dim(max_sh_degree)),
                    np.float32)
    return from_arrays(pts, rots, scales.astype(np.float32), density, color,
                       spec, capacity, device)


def rgb_to_sh(rgb):
    return (rgb - 0.5) / SH_C0


def nearest_neighbor_dist(points: np.ndarray,
                          targets: Optional[np.ndarray] = None) -> np.ndarray:
    """Distance to the nearest other point (or to the nearest target) by a
    KD-tree on the host."""
    from scipy.spatial import cKDTree
    if targets is None:
        d, _ = cKDTree(points).query(points, k=2)
        return d[:, 1].astype(np.float32)
    d, _ = cKDTree(targets).query(points, k=1)
    return d.astype(np.float32)


def init_from_points(points: np.ndarray, colors: Optional[np.ndarray] = None,
                     observer_points: Optional[np.ndarray] = None,
                     observation_scale_factor: float = 0.01,
                     max_sh_degree: int = 3, default_density: float = 0.1,
                     default_scale_factor: float = 1.0, seed: int = 0,
                     capacity: Optional[int] = None,
                     device="cuda") -> Gaussians:
    """COLMAP-style init (reference model.py:438-489): scale from the
    distance to the observers (or the mean of the 3 nearest neighbours),
    albedo = RGB2SH(colour), random rotations. Numbers come from numpy's
    generator seeded with `seed`, so they equal the JAX package's."""
    from scipy.spatial import cKDTree
    rng = np.random.default_rng(seed)
    n = points.shape[0]
    pts = points.astype(np.float32)
    if observer_points is not None:
        d = nearest_neighbor_dist(pts, observer_points.astype(np.float32))
        obs_scale = np.maximum(d, 1e-7) * observation_scale_factor
    else:
        d, _ = cKDTree(pts).query(pts, k=4)
        d2 = d.astype(np.float32)[:, 1:] ** 2
        obs_scale = np.sqrt(d2.mean(-1))
    obs_scale = obs_scale * default_scale_factor
    scales = np.log(obs_scale)[:, None].repeat(3, 1).astype(np.float32)
    rots = rng.uniform(0, 1, size=(n, 4)).astype(np.float32)
    if colors is None:
        colors = rng.integers(0, 256, size=(n, 3)).astype(np.float32) / 255.0
    else:
        colors = colors.astype(np.float32)
        if colors.max() > 1.0:
            colors = colors / 255.0
    albedo = rgb_to_sh(colors).astype(np.float32)
    density = np.full((n, 1), inverse_sigmoid(default_density), np.float32)
    spec = np.zeros((n, sh_degree_to_specular_dim(max_sh_degree)),
                    np.float32)
    return from_arrays(pts, rots, scales, density, albedo, spec, capacity,
                       device)


def bench_scene(n: int, seed: int = 0, specular_std: float = 0.0
                ) -> Dict[str, np.ndarray]:
    """Raw fields of the seeded benchmark scene of the JAX package's
    bench.py (normal positions, random quaternions, scales 0.004-0.02,
    opacity 0.5, albedo in [-1, 1], SH degree 3). `specular_std` > 0 adds
    normal SH 1-3 coefficients drawn after the reference's draws, so the
    first five arrays stay those of bench.py."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, 1.0, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.log(np.exp(rng.uniform(np.log(0.004), np.log(0.02),
                                       size=(n, 3)))).astype(np.float32)
    density = np.full((n, 1), 0.0, np.float32)
    albedo = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    spec = np.zeros((n, 45), np.float32)
    if specular_std > 0.0:
        spec = rng.normal(0, specular_std, size=(n, 45)).astype(np.float32)
    return padded_fields(pos, quats, scales, density, albedo, spec)
