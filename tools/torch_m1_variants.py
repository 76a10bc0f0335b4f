"""M1 (threedgrut_torch/csrc/mesh_intersect.cu) against variants of its own
source on one card: bits against the brute force and CUDA-event ms, in
turns, at four sets of rays of phase 5c's scene (chip_smoke.py's meshes,
camera and viewer at 800x800, over bench_scene's 20,000 particles): the
primary rays, a trace frame's bounce-2 and bounce-3 rays and a hybrid
frame's secondary rays.

Each variant is the checkout's source with a few lines replaced (VARIANTS;
a patch that no longer matches the source fails), built with the
kernel's own nvcc flags into build/m1_variants/:
  warp_cull  after the block's cull, each warp culls the block's list
             again over its own 32 rays' boxes and tests only what its
             ballot keeps (a warp with no live ray skips);
  tile1344   a 1,344-face tile with a 16-bit list, so that 4 blocks fit an
             SM (__launch_bounds__(256, 4)).
Per set it prints one JSON line: bit equality of each, ms (two rounds,
the second in reverse order), live blocks, the pairs the block's cull
leaves and the pairs the warps' culls leave, and chip_smoke.py's bound.

    python3 tools/torch_m1_variants.py     # on a machine with the card
"""
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from threedgrut_torch.ops import cuda_build  # noqa: E402
from threedgrut_torch.ops import mesh_intersect as mi  # noqa: E402

SOURCE = ROOT / "threedgrut_torch" / "csrc" / "mesh_intersect.cu"
OUT = ROOT / "build" / "m1_variants"

WARP_BOXES = (
    """        for (int k = 0; k < 12; ++k) red[warp][k] = box[k];
    }
""",
    """        for (int k = 0; k < 12; ++k) red[warp][k] = box[k];
    }
    const bool warp_live = __any_sync(FULL, live);
    const bool warp_keep_all = __any_sync(FULL, live && !finite);
    Iv wo[3], wd[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        wo[k] = {box[k], box[6 + k]};
        wd[k] = {box[3 + k], box[9 + k]};
    }
""")
WARP_TEST = (
    """        } else {
            // 4. The exact test over the list, every lane on the same face.
            for (int k = 0; k < nk; ++k) {
                const int j = list[k];
                pair_test(fs + 9 * j, base + j, o0, o1, o2, d0, d1, d2,
                          t_min, best_t, best_u, best_w, best_face);
            }
        }
""",
    """        } else if (warp_live) {
            for (int c = 0; c < nk; c += 32) {
                const int k = c + lane;
                const bool keep =
                    k < nk && (warp_keep_all ||
                               face_survives(fs + 9 * list[k], wo, wd,
                                             t_min));
                unsigned bits = __ballot_sync(FULL, keep);
                while (bits) {
                    const int j = list[c + __ffs(bits) - 1];
                    bits &= bits - 1u;
                    pair_test(fs + 9 * j, base + j, o0, o1, o2, d0, d1, d2,
                              t_min, best_t, best_u, best_w, best_face);
                }
            }
        }
""")
VARIANTS = {
    "warp_cull": [WARP_BOXES, WARP_TEST],
    "tile1344": [
        ("#define TILE 1536\n#define WORDS (TILE / 32)\n",
         "#define TILE 1344\n"
         "#define WORDS ((TILE + THREADS - 1) / THREADS * WARPS)\n"),
        ("TILE * (int)sizeof(int);", "TILE * (int)sizeof(unsigned short);"),
        ("TILE % THREADS == 0 && TILE % 4 == 0", "TILE % 4 == 0"),
        ("template <bool MASKS>\n__global__ void __launch_bounds__(THREADS)",
         "template <bool MASKS>\n"
         "__global__ void __launch_bounds__(THREADS, 4)"),
        ("int* list = reinterpret_cast<int*>(fs + TILE * 9);",
         "unsigned short* list =\n"
         "        reinterpret_cast<unsigned short*>(fs + TILE * 9);"),
    ],
}


def build_variant(name):
    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the patch no longer matches "
                             f"{SOURCE.name}: {old[:60]!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"{name}.cu").write_text(src)
    lib = OUT / f"lib{name}.so"
    cmd = [cuda_build._nvcc(), *cuda_build._BASE_FLAGS,
           *cuda_build.SOURCES["mesh_intersect"], "-o", str(lib),
           str(OUT / f"{name}.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    report = [x.strip() for x in (r.stdout + r.stderr).splitlines()
              if "registers" in x or "spill" in x]
    print(json.dumps(dict(variant=name, ptxas=report)), flush=True)
    so = ctypes.CDLL(str(lib))
    so.mesh_intersect.argtypes = mi._ARGS
    so.mesh_intersect.restype = ctypes.c_int
    return so


def run_variant(so, o, d, tri):
    n, nf = o.shape[0], tri.shape[0]
    out = [torch.empty(n, device=o.device),
           torch.empty(n, dtype=torch.int32, device=o.device),
           torch.empty(n, device=o.device), torch.empty(n, device=o.device)]
    cuda_build.check("mesh_intersect", so.mesh_intersect(
        o.data_ptr(), d.data_ptr(), tri.data_ptr(), n, nf, 1e-4,
        *(x.data_ptr() for x in out),
        torch.cuda.current_stream().cuda_stream))
    return out


def ray_sets(dev):
    """The four sets of rays (o, d) and the faces."""
    from threedgrut_torch.model.gaussians import bench_scene, from_numpy
    from threedgrut_torch.playground import engine as eng_mod
    from threedgrut_torch.playground.web_viewer import WebViewer
    glb = Path(tempfile.mkdtemp(prefix="m1_variants_")) / "card.glb"
    cs.write_glb(glb)
    sg = cs.playground_scene(dev, glb)
    p = from_numpy(bench_scene(20_000, seed=2, specular_std=0.1),
                   device=dev)
    engine = eng_mod.Engine(
        p.get_positions(), p.get_rotation(), p.get_scale(), p.get_density(),
        p.get_features(), mesh=sg.mesh(), materials=sg.materials(),
        envmap=cs.sky_envmap(),
        config=eng_mod.EngineConfig(max_bounces=cs.PG_BOUNCES,
                                    candidate_capacity=1 << 15),
        device=dev)
    viewer = WebViewer(engine, resolution=cs.MAIN_RES,
                       fov_deg=cs.pg_fov(cs.MAIN_RES), scene=sg)
    with torch.no_grad():
        viewer.mode = "trace"
        with cs.mesh_rays_recorded(cs.PG_BOUNCES) as trace:
            viewer.render_outputs(*cs.pg_camera(1))
        viewer.mode = "hybrid"
        with cs.mesh_rays_recorded(cs.PG_BOUNCES + 1) as hybrid:
            viewer.render_outputs(*cs.pg_camera(1))
    sets = {"primary": hybrid.calls[0], "trace bounce-2": trace.calls[1],
            "trace bounce-3": trace.calls[2],
            "hybrid secondary": hybrid.calls[1]}
    tri = mi.triangles(engine.mesh.vertices, engine.mesh.faces)
    return sets, tri


def warp_pairs(o, d, tri, block_masks):
    """Pairs the warp_cull variant tests: each ray of a warp with a live
    ray against the faces both its block's and its warp's culls keep (a
    warp's box lies inside its block's, so its cull is as exact)."""
    warp = 32
    wm = mi.block_face_masks_plain(o, d, tri, block=warp)
    per = mi.BLOCK // warp
    bm = block_masks.repeat_interleave(per, 0)[:wm.shape[0]]
    r = o.shape[0]
    rays = (r - warp * torch.arange(wm.shape[0], device=o.device)).clamp(
        max=warp)
    return int(((wm & bm).sum(1) * rays).sum())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    cuda_build.build(["mesh_intersect"])
    libs = {name: build_variant(name) for name in VARIANTS}
    sets, tri = ray_sets(dev)
    agree = True
    for name, (o, d) in sets.items():
        plain = mi.closest_hits_plain(o, d, tri)
        runs = {"checkout": lambda: mi.closest_hits(o, d, tri)}
        for k, so in libs.items():
            runs[k] = (lambda so=so: run_variant(so, o, d, tri))
        equal = {k: all(torch.equal(x, y) for x, y in zip(fn(), plain))
                 for k, fn in runs.items()}
        agree &= all(equal.values())
        ms = {k: [] for k in runs}
        for rnd in range(2):
            order = list(runs) if rnd == 0 else list(runs)[::-1]
            for k in order:
                ms[k].append(cs.cuda_ms(runs[k], 20))
        cull = mi.block_cull_plain(o, d, tri)
        live, pairs, live_pairs, bound = cs.m1_work(o, d, tri, cull)
        print(json.dumps(dict(
            set=name, rays=o.shape[0], faces=tri.shape[0],
            active_rays=int((d != 0).any(-1).sum()), bit_equal=equal, ms=ms,
            live_blocks=live, pairs_block=pairs,
            pairs_warp=warp_pairs(o, d, tri, cull[0]),
            live_pairs=live_pairs, bound_ms=bound[0])), flush=True)
    if not agree:
        raise SystemExit("a variant's outputs differ from the brute force")


if __name__ == "__main__":
    main()
