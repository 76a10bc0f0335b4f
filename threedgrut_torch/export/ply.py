"""3DGS-ecosystem PLY export and import, port of
threedgrut_tpu/export/ply.py.

Format (reference threedgrut/export/ply_exporter.py): binary little-endian
PLY, one 'vertex' element with x/y/z, nx/ny/nz (0, 0, 1), f_dc_{0..2},
f_rest_{k} in channel-major (F) order, opacity (pre-sigmoid), scale_{0..2}
(log), rot_{0..3} (wxyz, not normalized), all float32. Only alive rows are
written; import pads to a capacity as model.gaussians.from_arrays does.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from threedgrut_torch.export import alive_rows
from threedgrut_torch.model.gaussians import Gaussians, from_arrays


def _attribute_names(n_rest: int):
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(n_rest)]
    names += ["opacity", "scale_0", "scale_1", "scale_2",
              "rot_0", "rot_1", "rot_2", "rot_3"]
    return names


def export_ply(params: Gaussians, path: str) -> None:
    rows = alive_rows(params)
    n = rows["positions"].shape[0]
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))
    spec = rows["features_specular"]
    k = spec.shape[1] // 3
    # [N, K*3] stored [coeff, channel] -> channel-major f_rest (F order).
    spec_f = spec.reshape(n, k, 3).transpose(0, 2, 1).reshape(n, k * 3)
    attrs = np.concatenate(
        [rows["positions"], nrm, rows["features_albedo"], spec_f,
         rows["density"], rows["scale"], rows["rotation"]],
        axis=1).astype("<f4")
    names = _attribute_names(spec_f.shape[1])
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {a}" for a in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(attrs.tobytes())


def read_ply_fields(path: str) -> Dict[str, np.ndarray]:
    """Minimal binary-little-endian float32 PLY vertex reader."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii").splitlines()
    n = None
    props = []
    fmt = None
    for line in header:
        t = line.split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element" and t[1] == "vertex":
            n = int(t[2])
        elif t[0] == "property" and n is not None:
            if t[1] not in ("float", "float32"):
                raise ValueError(f"unsupported property type {t[1]}")
            props.append(t[2])
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported ply format {fmt}")
    arr = np.frombuffer(data[head_end:], dtype="<f4",
                        count=n * len(props)).reshape(n, len(props))
    return {p: arr[:, i].copy() for i, p in enumerate(props)}


def import_ply(path: str, capacity: Optional[int] = None,
               device="cuda") -> Gaussians:
    """A 3DGS-format PLY as a Gaussians module on `device`, padded to
    `capacity` (default round_capacity of its row count)."""
    fields = read_ply_fields(path)
    n = fields["x"].shape[0]
    pos = np.stack([fields["x"], fields["y"], fields["z"]], -1)
    albedo = np.stack([fields[f"f_dc_{i}"] for i in range(3)], -1)
    rest_names = sorted((k for k in fields if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    if rest_names:
        rest = np.stack([fields[k] for k in rest_names], -1)  # [N, 3K] F
        k = rest.shape[1] // 3
        spec = rest.reshape(n, 3, k).transpose(0, 2, 1).reshape(n, k * 3)
    else:
        spec = np.zeros((n, 0), np.float32)
    density = fields["opacity"][:, None]
    scales = np.stack([fields[f"scale_{i}"] for i in range(3)], -1)
    rot = np.stack([fields[f"rot_{i}"] for i in range(4)], -1)
    return from_arrays(pos, rot, scales, density, albedo, spec,
                       capacity=capacity, device=device)
