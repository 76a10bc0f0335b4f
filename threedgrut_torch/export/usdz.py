"""USDZ export for Omniverse/Isaac NuRec ingestion, port of
threedgrut_tpu/export/usdz.py, without a pxr dependency.

Reference: threedgrut/export/{usdz_exporter.py, usd_util.py,
nurec_templates.py, normalizing_transform.py}. The package is a USDZ zip
(stored, no compression) holding, in this order, the default `.usda` layer,
the `_gauss.usda` layer (a Volume prim with the nurec asset reference,
extents from the position bounds and the 3DGRUT -> USD axis conversion) and
the `.nurec` blob: gzip at level 0 over MessagePack (the port's `_msgpack`)
of the NuRec template, whose state_dict holds fp16 parameter bytes. The
layers are usda text, so the exporter runs without OpenUSD.
"""
from __future__ import annotations

import gzip
import io
import zipfile
from typing import Optional

import numpy as np

from threedgrut_torch.export import _msgpack, alive_rows
from threedgrut_torch.model.gaussians import Gaussians

# Default conversion matrix 3DGRUT -> USDZ (usd_util.py:145-150).
_CONV_TF = np.array([
    [-1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])


def estimate_normalizing_transform(poses: np.ndarray) -> np.ndarray:
    """Move the mean camera to the origin and align the mean down direction
    with world Y (reference normalizing_transform.py:4-55)."""
    if len(poses) == 0:
        return np.eye(4)
    poses = np.asarray(poses)           # datasets may hand a list of 4x4s
    positions = poses[:, :3, 3]
    avg_position = positions.mean(axis=0)
    avg_down = poses[:, :3, 1].mean(axis=0)
    avg_down = avg_down / np.linalg.norm(avg_down)
    target = np.array([0.0, 1.0, 0.0])
    v = np.cross(avg_down, target)
    s = np.linalg.norm(v)
    c = float(np.dot(avg_down, target))
    if s < 1e-6:
        R = np.eye(3)
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = -R @ avg_position
    return T


def build_nurec_template(params: Gaussians, n_active_features: int,
                         render_cfg=None) -> dict:
    """The NuRec MessagePack template (nurec_templates.
    fill_3dgut_template); `render_cfg` supplies the kernel degree, minimum
    response and transmittance threshold where it has them."""
    rows = alive_rows(params)
    pos, rot, scl = rows["positions"], rows["rotation"], rows["scale"]
    dns, alb = rows["density"], rows["features_albedo"]
    spec = rows["features_specular"]
    rc = render_cfg

    def sd_entry(arr):
        return arr.astype(np.float16).tobytes()

    g = ".gaussians_nodes.gaussians."
    state = {
        g + "positions": sd_entry(pos),
        g + "rotations": sd_entry(rot),
        g + "scales": sd_entry(scl),
        g + "densities": sd_entry(dns),
        g + "features_albedo": sd_entry(alb),
        g + "features_specular": sd_entry(spec),
        g + "extra_signal": np.zeros((pos.shape[0], 0),
                                     np.float16).tobytes(),
        g + "n_active_features": np.asarray([n_active_features],
                                            np.int64).tobytes(),
        g + "positions.shape": list(pos.shape),
        g + "rotations.shape": list(rot.shape),
        g + "scales.shape": list(scl.shape),
        g + "densities.shape": list(dns.shape),
        g + "features_albedo.shape": list(alb.shape),
        g + "features_specular.shape": list(spec.shape),
        g + "extra_signal.shape": [pos.shape[0], 0],
        g + "n_active_features.shape": [],
    }
    return {
        "nre_data": {
            "version": "0.2.576",
            "model": "nre",
            "config": {
                "layers": {
                    "gaussians": {
                        "name": "sh-gaussians",
                        "device": "cuda",
                        "density_activation": "sigmoid",
                        "scale_activation": "exp",
                        "rotation_activation": "normalize",
                        "precision": 16,
                        "particle": {
                            "density_kernel_planar": False,
                            "density_kernel_degree":
                                getattr(rc, "particle_kernel_degree", 2),
                            "density_kernel_density_clamping": False,
                            "density_kernel_min_response":
                                getattr(rc, "particle_kernel_min_response",
                                        0.0113),
                            "radiance_sph_degree": 3,
                        },
                        "transmittance_threshold":
                            getattr(rc, "min_transmittance", 0.0001),
                    }
                },
                "renderer": {"name": "3dgut-nrend"},
            },
            "state_dict": state,
        }
    }


def _matrix_rows(m: np.ndarray) -> str:
    return ", ".join(
        "(" + ", ".join(f"{v:.9g}" for v in row) + ")" for row in m)


def _gauss_usda(nurec_name: str, positions: np.ndarray,
                normalizing_transform: np.ndarray) -> str:
    lo = positions.min(axis=0)
    hi = positions.max(axis=0)
    xf = (np.linalg.inv(normalizing_transform) @ _CONV_TF).T  # USD row-major
    return f"""#usda 1.0
(
    defaultPrim = "World"
    metersPerUnit = 1
    upAxis = "Y"
)

def Xform "World"
{{
    def Volume "gauss" (
        prepend apiSchemas = ["NuRecVolumeAPI"]
    )
    {{
        float3[] extent = [({lo[0]:.6g}, {lo[1]:.6g}, {lo[2]:.6g}), ({hi[0]:.6g}, {hi[1]:.6g}, {hi[2]:.6g})]
        asset nurec:file = @./{nurec_name}@
        matrix4d xformOp:transform = ( {_matrix_rows(xf)} )
        uniform token[] xformOpOrder = ["xformOp:transform"]
    }}
}}
"""


def _default_usda(gauss_layer: str) -> str:
    return f"""#usda 1.0
(
    defaultPrim = "World"
    metersPerUnit = 1
    upAxis = "Y"
    subLayers = [@./{gauss_layer}@]
)
"""


def export_usdz(params: Gaussians, path: str,
                n_active_features: int = 3,
                render_cfg=None,
                dataset_poses: Optional[np.ndarray] = None,
                apply_normalizing_transform: bool = True) -> None:
    """Write the alive rows as a NuRec USDZ. With `dataset_poses` (camera to
    world 4x4s) and `apply_normalizing_transform`, the layer's transform
    undoes estimate_normalizing_transform of those poses; else identity."""
    stem = path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
    template = build_nurec_template(params, n_active_features, render_cfg)
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", compresslevel=0) as f:
        f.write(_msgpack.packb(template))
    nurec_bytes = buf.getvalue()

    nt = np.eye(4)
    if apply_normalizing_transform and dataset_poses is not None:
        nt = estimate_normalizing_transform(dataset_poses)

    positions = alive_rows(params)["positions"]
    nurec_name = stem + ".nurec"
    gauss_name = stem + "_gauss.usda"
    default_name = stem + ".usda"
    gauss_usda = _gauss_usda(nurec_name, positions, nt)
    default_usda = _default_usda(gauss_name)

    # USDZ: zip, stored (no compression), first file must be a USD layer.
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        z.writestr(default_name, default_usda)
        z.writestr(gauss_name, gauss_usda)
        z.writestr(nurec_name, nurec_bytes)
