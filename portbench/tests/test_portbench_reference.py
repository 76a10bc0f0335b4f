"""The plain references against the program's renderers at a CPU size,
where both compute the same thing exactly: a frame of each renderer, the
blockwise backward against one whole-frame autograd pass, and the mesh
hits with their normals and tangents."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import cells, pgscene, run, scene
from portbench.reference import playground as P
from portbench.reference import render as R

SEED = 7


@pytest.fixture(scope="module")
def small():
    _, _, cfg, _, _ = run.cell("gut_mcmc_train")
    cfg = copy.deepcopy(cfg)
    cfg["particles"] = 3000
    cfg["scene"].update(width=64, height=48, focal=60.0, captures=16,
                        train_views=14)
    dev = torch.device("cpu")
    raw = scene.particles(cfg, SEED, dev)
    return cfg, raw, scene.ring_poses(cfg)[0]


def program_frame(method, cfg, raw, T):
    from threedgrut_torch import trainer
    from threedgrut_torch.cameras import pose_from_matrix
    from threedgrut_torch.device import tuple_to
    from threedgrut_torch.render import grt, gut
    dev = torch.device("cpu")
    p = cells.gaussians(raw)
    args = [x.detach() for x in trainer.render_params(p)]
    cam = tuple_to(cells.program_camera(cfg), dev)
    Tm = torch.tensor(T)
    res = (cfg["scene"]["width"], cfg["scene"]["height"])
    if method == "grt":
        out, ovf = grt.render(*args, cam, pose_from_matrix(Tm), res,
                              sh_degree=3, kernel_degree=4,
                              min_transmittance=1e-3,
                              candidate_capacity=4096, flat_capacity=1 << 20,
                              T_to_world=Tm, device=dev)
    else:
        out, ovf = gut.render(*args, cam, pose_from_matrix(Tm), res, 1 << 20,
                              sh_degree=3, T_to_world=Tm, device=dev)
    assert not bool(ovf)
    return out.rgb


@pytest.mark.parametrize("mode", ("gut", "grt"))
def test_reference_frame_matches_the_program(small, mode):
    cfg, raw, T = small
    want = R.render(mode, R.activate(raw), scene.camera(cfg, T, "cpu"), 3)
    got = program_frame(mode, cfg, raw, T)
    assert float(want.abs().mean()) > 1e-3          # the frame is not empty
    assert float((got - want).abs().max()) < 1e-3


def test_reference_gradients_match_autograd_of_a_dense_blend(small):
    """render_with_grad's blockwise backward equals autograd through one
    whole-frame render."""
    cfg, raw, T = small
    cam = scene.camera(cfg, T, "cpu")
    gt = torch.rand((cfg["scene"]["height"], cfg["scene"]["width"], 3),
                    generator=torch.Generator().manual_seed(0))
    leaves = {k: (v.clone().requires_grad_(True) if v.is_floating_point()
                  else v) for k, v in raw.items()}
    R.render_with_grad("gut", R.activate(leaves), cam, 3,
                       lambda img: (None, 2 * (img - gt)), budget=1 << 14)
    blocked = leaves["features_albedo"].grad.clone()
    leaves2 = {k: (v.clone().requires_grad_(True) if v.is_floating_point()
                   else v) for k, v in raw.items()}
    a = R.activate(leaves2)
    frame = R.prepare_frame("gut", a, cam, 1 << 30)
    cols = R.colour_source("gut", a, cam, 3)
    ins = R.padded_inputs(a, cols)
    parts = []
    for blk in frame.blocks:
        tiles, ids, valid = R.block_ids(frame, blk, a.positions.shape[0])
        parts.append((tiles, R.composite_block(
            "gut", *ins, ids, valid, frame.dirs[tiles], frame.origin, 3)[0]))
    img = R.to_image(frame, cam, parts, 3)
    ((img - gt) ** 2).sum().backward()
    assert torch.allclose(blocked, leaves2["features_albedo"].grad,
                          rtol=1e-4, atol=1e-7)


def test_mesh_hits_match_the_program():
    from threedgrut_torch.playground import mesh as mesh_mod
    _, _, cfg, traffic, _ = run.cell("pg_hybrid_orbit")
    parts = pgscene.meshes(cfg)
    ref = P.build_mesh(parts, "cpu")
    prog = mesh_mod.merge_meshes([mesh_mod.make_mesh(v, f, mid, uvs=uv,
                                                     device="cpu")
                                  for v, f, uv, mid in parts])
    g = torch.Generator().manual_seed(1)
    o = torch.tensor([0.0, -3.5, 1.0]) + 0.1 * torch.randn((4096, 3),
                                                           generator=g)
    d = torch.nn.functional.normalize(torch.tensor([0.0, 1.0, -0.3])
                                      + 0.4 * torch.randn((4096, 3),
                                                          generator=g),
                                      dim=-1)
    want = P.closest_hit(ref, o, d)
    got = mesh_mod.intersect(prog, o, d)
    assert int((want.material >= 0).sum()) > 500
    assert torch.equal(want.material, got.material_id.long())
    hit = want.material >= 0
    assert torch.allclose(want.t[hit], got.t[hit], rtol=1e-6)
    assert torch.allclose(want.normal, got.normal, atol=1e-6)
    assert torch.allclose(want.tangent[hit], got.tangent[hit], atol=1e-5)
