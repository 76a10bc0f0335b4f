"""Convert a 3DGS PLY into a NuRec USDZ (the port's counterpart of
scripts/ply_to_usd.py; reference threedgrut/export/scripts/ply_to_usd.py):

    python -m threedgrut_torch.export.ply_to_usd model.ply \
        [--output_file model.usdz]

Conversion is host work: the scene is read onto the CPU, no card needed.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m threedgrut_torch.export.ply_to_usd",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("ply_file")
    ap.add_argument("--output_file", default=None)
    args = ap.parse_args(argv)

    from threedgrut_torch.export.ply import import_ply
    from threedgrut_torch.export.usdz import export_usdz

    out = args.output_file or args.ply_file.rsplit(".", 1)[0] + ".usdz"
    params = import_ply(args.ply_file, device="cpu")
    export_usdz(params, out, apply_normalizing_transform=False)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
