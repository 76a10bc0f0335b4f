"""Digests of B1's and B2's sorted legs on the card, to hold two versions
of the kernels bit for bit against each other:

    python threedgrut_torch/golden/digest.py [--root CHECKOUT]

`--root` names the checkout whose `threedgrut_torch` is imported (default:
the one holding this file), so one run can digest another version's
kernels with the same inputs. For each scene and leg it prints one line:
the sha256 (first 16 hex digits) of B1's output [num_tiles, 8, 256] and
flags, and of B2's gradients [cap, 16] for a seeded output cotangent.
Scenes: 20k Gaussians at 256x192 (scales raised 4x) and bench.py's 1M
scene at 800x800 (capacity 2,917,888), both from (0.3, -4, 1)."""
from __future__ import annotations

import argparse
import hashlib
import sys
from pathlib import Path

import numpy as np

# (name, sorted_passes, row termination at each tile's midpoint slot,
# emit_flags)
LEGS = [("sorted1", 1, False, False), ("sorted2", 2, False, False),
        ("sorted16", 16, False, False), ("sorted16-flags", 16, False, True),
        ("sorted16-rowterm-mid", 16, True, False),
        ("sorted70", 70, False, False)]
SCENES = [("20k-256x192", 20_000, (256, 192), 1 << 18, True),
          ("1M-800x800", 1_000_000, (800, 800), 2_917_888, False)]


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch
    from threedgrut_torch.cameras import (example_camera, look_at,
                                          pose_from_matrix)
    from threedgrut_torch.model.gaussians import bench_scene, from_numpy
    from threedgrut_torch.ops import tile_raster
    from threedgrut_torch.render import gut
    if not torch.cuda.is_available():
        print("digest: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    for sname, n, res, cap, raise_scale in SCENES:
        fields = bench_scene(n, seed=2, specular_std=0.1)
        if raise_scale:
            fields["scale"] = fields["scale"] + np.float32(np.log(4.0))
        p = from_numpy(fields, device=dev)
        T = look_at(np.array([0.3, -4.0, 1.0], np.float32),
                    np.zeros(3, np.float32), np.array([0, 0, 1.0], np.float32))
        cam = example_camera(res, dev)
        pose = pose_from_matrix(torch.tensor(T, device=dev))
        with torch.no_grad():
            _, binning, data, grid = gut.prepare(
                p.get_positions(), p.get_rotation(), p.get_scale(),
                p.get_density(), p.get_features(), cam, pose, res, cap)
            rays = gut.packed_world_rays(cam, pose, grid)
        s, e = binning.tile_starts, binning.tile_ends
        mid = torch.where(e > s, torch.div(s + e, 2, rounding_mode="floor"),
                          -1).to(torch.float32)
        for lname, passes, rowterm, flags in LEGS:
            r = rays.clone()
            if rowterm:
                r[:, 7] = mid[:, None]
            fwd = (data, s, e, r, 2, 1e-4, 0.0113, 1.0 / 255.0, 0.99, False)
            out, fl = tile_raster._launch(*fwd, True, flags, passes, rowterm)
            g_out = torch.randn(out.shape, device=dev,
                                generator=torch.Generator(dev).manual_seed(0))
            grad = tile_raster._launch_backward(
                *fwd[:4], out, g_out, *fwd[4:], True, passes, rowterm)
            torch.cuda.synchronize()
            print(f"digest {sname} {lname}: B1 {digest(out, fl)} "
                  f"B2 {digest(grad)} (walked {int(out[:, 7, 0].sum())}, "
                  f"nonzero rows {int((grad.abs().sum(1) > 0).sum())})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
