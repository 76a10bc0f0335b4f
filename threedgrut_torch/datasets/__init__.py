"""Dataset factory, port of threedgrut_tpu/datasets/__init__.py."""
from __future__ import annotations


def make(name: str, path: str, split: str = "train", device="cuda", **kw):
    """The dataset of type `name` ("nerf", "nerf_synthetic" or "blender";
    "colmap"; "scannetpp"; "synthetic") at `path`. `device` is where the
    synthetic scene renders its ground truth; the others decode on the
    host. The synthetic scene takes the keywords its constructor names and
    ignores the rest."""
    if name in ("nerf", "nerf_synthetic", "blender"):
        from threedgrut_torch.datasets.dataset_nerf import NeRFDataset
        return NeRFDataset(path, split=split,
                           downsample_factor=kw.get("downsample_factor", 1),
                           bg_color=kw.get("bg_color"),
                           shutter_type=kw.get("shutter_type", "global"))
    if name in ("colmap", "scannetpp"):
        from threedgrut_torch.datasets.dataset_colmap import (
            ColmapDataset, ScannetppDataset)
        cls = ColmapDataset if name == "colmap" else ScannetppDataset
        return cls(path, split=split,
                   downsample_factor=kw.get("downsample_factor", 1),
                   test_split_interval=kw.get("test_split_interval", 8),
                   shutter_type=kw.get("shutter_type", "global"))
    if name == "synthetic":
        import inspect
        from threedgrut_torch.datasets.dataset_synthetic import (
            SyntheticDataset)
        accepted = set(inspect.signature(SyntheticDataset).parameters)
        return SyntheticDataset(device=device,
                                **{k: v for k, v in kw.items()
                                   if k in accepted and k != "device"})
    raise ValueError(f"unknown dataset type {name!r}")
