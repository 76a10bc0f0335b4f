"""Render/eval entry point of the port, the counterpart of the repository's
root render.py (here, as `threedgrut_torch.render` is the renderers'
package, its `__main__` module):

    python -m threedgrut_torch.render --checkpoint runs/lego/ckpt_last.npz \
        [--path data/lego] [--split test] [--out-dir render_out] \
        [--save-gt] [--compute-extra-metrics] [--device cuda|cpu]

The dataset's type, path and (unlike the root render.py) downsample factor
and shutter come from the checkpoint's .json config unless given here; a
synthetic scene is rebuilt from it (its views, resolution, ground-truth
particles and multi-sensor rig). Renders and scores the split through
render_eval.Renderer (the 3DGRT eval overrides included) and prints the
summary as JSON. Runs on the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def run(argv=None) -> dict:
    """Render and score as the command line says; returns the summary."""
    from threedgrut_torch import datasets
    from threedgrut_torch.config import DatasetConfig, from_dict
    from threedgrut_torch.device import resolve
    from threedgrut_torch.render_eval import Renderer
    from threedgrut_torch.train import dataset_kwargs

    ap = argparse.ArgumentParser(
        prog="python -m threedgrut_torch.render",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--path", default=None,
                    help="dataset path (default: the checkpoint's)")
    ap.add_argument("--dataset-type", default=None,
                    help="nerf|colmap|scannetpp|synthetic (default: the "
                         "checkpoint's)")
    ap.add_argument("--split", default="test")
    ap.add_argument("--out-dir", default="render_out")
    ap.add_argument("--save-gt", action="store_true")
    ap.add_argument("--compute-extra-metrics", action="store_true",
                    help="also compute LPIPS (host, torchmetrics)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    ds_cfg = DatasetConfig()
    cfg_path = os.path.splitext(args.checkpoint)[0] + ".json"
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            ds_cfg = from_dict(json.load(f)).dataset
    ds_cfg.type = args.dataset_type or ds_cfg.type
    ds_cfg.path = args.path or ds_cfg.path
    if not ds_cfg.path and ds_cfg.type != "synthetic":
        ap.error("--path required (the checkpoint stores no dataset path)")
    dataset = datasets.make(ds_cfg.type, ds_cfg.path, split=args.split,
                            device=dev, **dataset_kwargs(ds_cfg))
    renderer = Renderer.from_checkpoint(args.checkpoint, dataset, device=dev)
    summary = renderer.render_all(out_dir=args.out_dir, save_gt=args.save_gt,
                                  compute_lpips=args.compute_extra_metrics)
    print(json.dumps(summary, indent=2), flush=True)
    return summary


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
