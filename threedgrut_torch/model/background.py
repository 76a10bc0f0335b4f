"""Background compositing after rendering, port of
threedgrut_tpu/model/background.py: black is a no-op, white blends a
constant, and during training the random background draws a per-pixel
colour from the caller's torch.Generator (eval renders it black)."""
from __future__ import annotations

from typing import Optional

import torch


def compose(rgb: torch.Tensor, opacity: torch.Tensor, color: str,
            train: bool = False,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """rgb [..., 3] pre-background radiance; opacity [...] accumulated
    alpha. Composed as rgb + (1 - opacity) * bg."""
    if color == "black":
        return rgb
    t = (1.0 - opacity)[..., None]
    if color == "white":
        return rgb + t
    if color == "random":
        if not train:
            return rgb
        if generator is None:
            raise ValueError("the random background needs a torch.Generator "
                             "in training")
        bg = torch.rand(rgb.shape, generator=generator, dtype=rgb.dtype,
                        device=rgb.device)
        return rgb + t * bg
    raise ValueError(f"unknown background color {color!r}")
