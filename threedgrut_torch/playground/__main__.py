"""Playground entry point of the port, the counterpart of the repository's
root playground.py:

    python -m threedgrut_torch.playground --gs_object scene.ply \
        [--mesh_assets DIR] [--envmap FILE] [--resolution W H] \
        [--max_bounces N] [--port 8080] [--no-serve] [--device cuda]

Loads a scene (.npz checkpoint, .ply or .ingp, through api.load_scene),
inserts the .obj and .glb files of --mesh_assets as named primitives of an
editable scene graph (the .obj files alternate between its mirror and
glass materials; a .glb brings its own), reads an equirect --envmap
through the native image loader, and serves the web viewer. With
--no-serve it renders one frame, prints its shape and mean, and exits.
Runs on the card (the default; an error without one) or, with --device
cpu, on the CPU through the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import os
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m threedgrut_torch.playground",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--gs_object", required=True,
                    help="scene: .npz checkpoint, .ply or .ingp")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--mesh_assets", default=None,
                    help="directory of .obj and .glb meshes to insert")
    ap.add_argument("--envmap", default=None, help="equirect image file")
    ap.add_argument("--resolution", type=int, nargs=2, default=(400, 400))
    ap.add_argument("--max_bounces", type=int, default=3)
    ap.add_argument("--no-serve", action="store_true",
                    help="render one frame and exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    return ap.parse_args(argv)


def build(args):
    """(WebViewer, SceneGraph) of the parsed arguments."""
    import torch

    from threedgrut_torch import api
    from threedgrut_torch.device import resolve
    from threedgrut_torch.playground import engine as eng_mod
    from threedgrut_torch.playground import materials as mat_mod
    from threedgrut_torch.playground import mesh as mesh_mod
    from threedgrut_torch.playground.scene import SceneGraph
    from threedgrut_torch.playground.web_viewer import WebViewer

    dev = resolve(args.device)
    g = api.load_scene(args.gs_object, device=dev)
    sg = SceneGraph(material_specs=[
        dict(kind=mat_mod.MaterialKind.MIRROR, base_color=(0.95,) * 3),
        dict(kind=mat_mod.MaterialKind.GLASS, ior=1.33)], device=dev)
    if args.mesh_assets:
        for i, f in enumerate(sorted(os.listdir(args.mesh_assets))):
            name, ext = os.path.splitext(f)
            path = os.path.join(args.mesh_assets, f)
            if ext == ".obj":
                sg.add(name, mesh_mod.load_obj(path, i % 2, device=dev))
            elif ext == ".glb":
                from threedgrut_torch.playground.gltf import load_glb_scene
                glb_mesh, glb_specs = load_glb_scene(path, device=dev)
                if glb_mesh is None:
                    continue
                off = len(sg.material_specs)
                for spec in glb_specs:
                    sg.add_material(spec)
                glb_mesh.material_id = glb_mesh.material_id + off
                sg.add(name, glb_mesh)
    envmap = None
    if args.envmap:
        from threedgrut_torch.datasets.native_loader import (ImageLoader,
                                                             load_rgb)
        loader = ImageLoader(n_threads=1)
        try:
            envmap = torch.tensor(load_rgb(loader, args.envmap)[..., :3],
                                  device=dev)
        finally:
            loader.close()
    with torch.no_grad():
        acts = (g.get_positions(), g.get_rotation(), g.get_scale(),
                g.get_density(), g.get_features())
    engine = eng_mod.Engine(
        *acts, mesh=sg.mesh(), materials=sg.materials(), envmap=envmap,
        config=eng_mod.EngineConfig(max_bounces=args.max_bounces),
        device=dev)
    return WebViewer(engine, resolution=tuple(args.resolution),
                     scene=sg), sg


def main(argv=None) -> int:
    args = parse_args(argv)
    viewer, _ = build(args)
    if args.no_serve:
        frame = viewer.render_frame(0.6, 0.4, 4.0)
        print(f"rendered {frame.shape}, mean {float(frame.mean()):.4f}",
              flush=True)
        return 0
    viewer.serve(port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
