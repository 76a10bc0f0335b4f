"""Scene export and import, port of threedgrut_tpu/export/: 3DGS PLY
(`ply`), Instant-NGP `.ingp` (`ingp`), NuRec USDZ (`usdz`) and the PLY to
USDZ converter (`python -m threedgrut_torch.export.ply_to_usd`). Export is
host work: the alive rows are copied to numpy and written from there.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from threedgrut_torch.model.gaussians import FIELDS


def alive_rows(params) -> Dict[str, np.ndarray]:
    """The six raw fields of the alive particles of a Gaussians module, in
    slot order, as float32 numpy arrays on the host."""
    alive = params.alive.detach().cpu().numpy()
    return {f: getattr(params, f).detach().cpu().numpy()[alive]
            for f in FIELDS if f != "alive"}
