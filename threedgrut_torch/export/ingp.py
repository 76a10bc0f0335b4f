"""Instant-NGP (.ingp) export and import, port of
threedgrut_tpu/export/ingp.py: gzip-compressed MessagePack (the port's own
`_msgpack`) of raw pre-activation parameter bytes.

Format (reference threedgrut/export/ingp_exporter.py): keys nre_data
{version, model: "mogt"}, precision ("single" | "half"), mog_num,
mog_sph_degree, and flat little-endian byte blobs mog_{positions, scales,
rotations, densities, features}, where features = concat(albedo [N, 3],
specular [N, ((d + 1)^2 - 1) * 3]) for the declared degree d.
"""
from __future__ import annotations

import gzip
from typing import Optional

import numpy as np

from threedgrut_torch.export import _msgpack, alive_rows
from threedgrut_torch.model.gaussians import Gaussians, from_arrays


def export_ingp(params: Gaussians, path: str, force_half: bool = False,
                max_sh_degree: Optional[int] = None) -> None:
    """Write the alive rows. `max_sh_degree` below the scene's degree keeps
    only the first (d + 1)^2 SH coefficients, so that the blob matches the
    degree it declares (the JAX exporter writes every coefficient, ROADMAP
    C14); above the scene's degree it raises ValueError."""
    deg = params.max_sh_degree
    if max_sh_degree is not None:
        if max_sh_degree > deg:
            raise ValueError(f"max_sh_degree {max_sh_degree} exceeds the "
                             f"scene's SH degree {deg}")
        deg = max_sh_degree
    dtype = np.float16 if force_half else np.float32
    rows = alive_rows(params)
    n_spec = ((deg + 1) ** 2 - 1) * 3
    features = np.concatenate(
        [rows["features_albedo"], rows["features_specular"][:, :n_spec]],
        axis=1)
    blob = {
        "nre_data": {"version": "0.0.1", "model": "mogt"},
        "precision": "half" if force_half else "single",
        "mog_num": int(rows["positions"].shape[0]),
        "mog_sph_degree": int(deg),
        "mog_positions": rows["positions"].astype(dtype).tobytes(),
        "mog_scales": rows["scale"].astype(dtype).tobytes(),
        "mog_rotations": rows["rotation"].astype(dtype).tobytes(),
        "mog_densities": rows["density"].astype(dtype).tobytes(),
        "mog_features": features.astype(dtype).tobytes(),
    }
    with gzip.open(path, "wb") as f:
        f.write(_msgpack.packb(blob))


def import_ingp(path: str, capacity: Optional[int] = None,
                device="cuda") -> Gaussians:
    """An .ingp file as a Gaussians module on `device`, padded to
    `capacity` (default round_capacity of its row count)."""
    with gzip.open(path, "rb") as f:
        blob = _msgpack.unpackb(f.read())
    n = blob["mog_num"]
    dtype = np.float16 if blob["precision"] == "half" else np.float32

    def arr(key, cols):
        a = np.frombuffer(blob[key], dtype=dtype).astype(np.float32)
        return a.reshape(n, cols)

    feats = arr("mog_features", (blob["mog_sph_degree"] + 1) ** 2 * 3)
    return from_arrays(
        arr("mog_positions", 3), arr("mog_rotations", 4),
        arr("mog_scales", 3), arr("mog_densities", 1),
        feats[:, :3], feats[:, 3:], capacity=capacity, device=device)
