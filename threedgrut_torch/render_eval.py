"""Evaluation renderer, port of threedgrut_tpu/render_eval.py: render a test
split from a checkpoint, save the images and score them (PSNR, SSIM, LPIPS
where torchmetrics is installed).

`Renderer.from_checkpoint` applies the eval overrides (3DGRT: minimum
transmittance MIN_TRANSMITTANCE_3DGRT_EVAL and density clamping), then
`render_all` renders every view through `Trainer.eval_view` (grow and retry
on overflow), scores it on the device, and reports the means, the best and
worst frames and the mean render time, each render ended by a device
synchronize.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from threedgrut_torch import constants as C
from threedgrut_torch.trainer import Trainer


def _to_uint8(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)


def _save_png(path: str, img) -> None:
    from PIL import Image
    Image.fromarray(_to_uint8(img)).save(path)


class _LPIPS:
    """torchmetrics' LPIPS (VGG) on the host CPU, built on first use; NaN
    where torchmetrics is not installed or its network cannot be built
    (its weights are downloaded on first use)."""

    def __init__(self):
        self._metric = None
        self.available = True

    def __call__(self, pred: np.ndarray, gt: np.ndarray) -> float:
        if not self.available:
            return float("nan")
        if self._metric is None:
            try:
                from torchmetrics.image.lpip import (
                    LearnedPerceptualImagePatchSimilarity)
                self._metric = LearnedPerceptualImagePatchSimilarity(
                    net_type="vgg", normalize=True)
            except (ImportError, OSError, RuntimeError) as e:
                print(f"LPIPS unavailable ({type(e).__name__}: {e}); "
                      f"left out of the summary", flush=True)
                self.available = False
                return float("nan")
        a, b = (torch.from_numpy(np.ascontiguousarray(
            x.transpose(2, 0, 1)))[None].float().clamp(0, 1)
            for x in (pred, gt))
        return float(self._metric(a, b))


class Renderer:
    def __init__(self, trainer: Trainer, dataset):
        self.trainer = trainer
        self.dataset = dataset

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, dataset,
                        device="cuda") -> "Renderer":
        trainer = Trainer.load_checkpoint(checkpoint_path, dataset=None,
                                          device=device)
        if trainer.cfg.render.method == "3dgrt":
            trainer.cfg.render.min_transmittance = \
                C.MIN_TRANSMITTANCE_3DGRT_EVAL
            trainer.cfg.render.particle_kernel_density_clamping = True
        trainer.dataset = dataset
        trainer.scene_extent = float(dataset.scene_extent)
        return cls(trainer, dataset)

    def _sync(self) -> None:
        if self.trainer.device.type == "cuda":
            torch.cuda.synchronize(self.trainer.device)

    def render_all(self, out_dir: Optional[str] = None, save_gt: bool = False,
                   compute_lpips: bool = True) -> Dict[str, float]:
        """Render and score every view. Returns the means of PSNR and SSIM
        (and LPIPS where it ran), the best and worst PSNR frames,
        `mean_render_s` (eval_view plus a device synchronize, the first
        view left out as warm-up), `n_frames` and `overflow_views` (views
        still truncated after eval_view's growth and retries). `out_dir`
        receives pred_NNNN.png (gt_NNNN.png with `save_gt`) and the best
        and worst pred/gt pairs."""
        from threedgrut_torch.model import losses
        lpips = _LPIPS() if compute_lpips else None
        dev = self.trainer.device
        rows: List[Dict[str, float]] = []
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        times = []
        n_ovf = 0
        for i in range(len(self.dataset)):
            view = self.dataset[i]
            self._sync()
            t0 = time.perf_counter()
            aux = self.trainer.eval_view(view)
            self._sync()
            times.append(time.perf_counter() - t0)
            if bool(aux["overflow"]):
                n_ovf += 1
                print(f"WARNING: eval view {i} overflowed isect capacity "
                      f"{self.trainer.isect_capacity}; image is truncated",
                      flush=True)
            pred = aux["pred"]
            gt = torch.as_tensor(view.rgb_gt, dtype=torch.float32,
                                 device=dev)
            row = {"psnr": float(aux["psnr"]),
                   "ssim": float(losses.ssim(pred, gt))}
            pred_np = pred.detach().cpu().numpy()
            if lpips is not None:
                row["lpips"] = lpips(pred_np, np.asarray(view.rgb_gt))
            rows.append(row)
            if out_dir:
                _save_png(os.path.join(out_dir, f"pred_{i:04d}.png"),
                          pred_np)
                if save_gt:
                    _save_png(os.path.join(out_dir, f"gt_{i:04d}.png"),
                              view.rgb_gt)

        psnrs = [r["psnr"] for r in rows]
        best_i, worst_i = int(np.argmax(psnrs)), int(np.argmin(psnrs))
        if out_dir:
            for tag, idx in (("best", best_i), ("worst", worst_i)):
                view = self.dataset[idx]
                aux = self.trainer.eval_view(view)
                _save_png(os.path.join(out_dir,
                                       f"{tag}_psnr_pred_{idx:04d}.png"),
                          aux["pred"])
                _save_png(os.path.join(out_dir,
                                       f"{tag}_psnr_gt_{idx:04d}.png"),
                          view.rgb_gt)
        summary = {
            "psnr": float(np.mean(psnrs)),
            "ssim": float(np.mean([r["ssim"] for r in rows])),
            "best_psnr_idx": best_i,
            "worst_psnr_idx": worst_i,
            "mean_render_s": (float(np.mean(times[1:])) if len(times) > 1
                              else float(times[0])),
            "n_frames": len(rows),
            "overflow_views": n_ovf,
        }
        lp = [r.get("lpips", float("nan")) for r in rows]
        if not np.all(np.isnan(lp)):
            summary["lpips"] = float(np.nanmean(lp))
        return summary
