"""The ranks of tests/test_torch_parallel.py and test_torch_multihost.py:
functions run in fresh processes (threedgrut_torch.parallel.multihost.spawn)
on the CPU over gloo. This module imports no JAX, so that a rank starts in
seconds; each returns numpy arrays and numbers.

The scene is tests/test_parallel.py's: SyntheticDataset(num_views=4,
resolution 32x32, 32 ground-truth Gaussians, seed 11), 64 slots initialized
from its points plus a seeded offset, isect_capacity 4096, a black
background, low_precision_grads off.
"""
import dataclasses
import hashlib
import os

import numpy as np
import torch

RES = (32, 32)


def dataset():
    from threedgrut_torch.datasets.dataset_synthetic import SyntheticDataset
    return SyntheticDataset(num_views=4, resolution=RES, num_gt_gaussians=32,
                            seed=11, device="cpu")


def initial_fields(ds):
    """The 64-slot initial parameters as numpy fields."""
    from threedgrut_torch.model import gaussians
    pts = np.asarray(ds.scene[0]) + np.random.default_rng(1).normal(
        0, 0.05, np.asarray(ds.scene[0]).shape).astype(np.float32)
    p = gaussians.init_from_points(pts, capacity=64, device="cpu")
    return {f: getattr(p, f).detach().numpy().copy()
            for f in gaussians.FIELDS}


def params_of(fields):
    from threedgrut_torch.model.gaussians import from_numpy
    return from_numpy(fields, device="cpu")


def config(preset=None):
    from threedgrut_torch.config import Config
    cfg = preset() if preset is not None else Config()
    cfg.render.isect_capacity = 1 << 12
    cfg.model.background_color = "black"
    cfg.render.low_precision_grads = False
    return cfg


def golden_config():
    """config() at the golden step's SH degree 3 from the first step (the
    JAX step there is built with sh_degree=3; Trainer's progressive SH
    starts at 0)."""
    cfg = config()
    cfg.model.progressive_sh_interval = 0
    return cfg


def golden_views(ds, g):
    """Views 0 and 1 with the golden file's poses and ground truths (the
    JAX package's), on the port's camera."""
    return [dataclasses.replace(ds[i], T_to_world=g["T_to_world"][i],
                                rgb_gt=g["rgb_gt"][i]) for i in range(2)]


def state_of(tr):
    """A trainer's replicated state as numpy: parameters, Adam's moments,
    the strategy's buffers."""
    from threedgrut_torch import optimizers
    from threedgrut_torch.model.gaussians import FIELDS
    out = {f"params/{f}": getattr(tr.params, f).detach().numpy().copy()
           for f in FIELDS}
    for f in optimizers.PARAM_FIELDS:
        out[f"m/{f}"] = tr.opt_state.exp_avg[f].numpy().copy()
        out[f"v/{f}"] = tr.opt_state.exp_avg_sq[f].numpy().copy()
    st = getattr(tr.strategy, "state", None)
    if st is not None:
        for f in dataclasses.fields(st):
            out[f"strategy/{f.name}"] = getattr(st, f.name).numpy().copy()
    return out


def digest(state) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k]).tobytes())
    return h.hexdigest()


def step_record(aux):
    return dict(grads={k: v.numpy().copy() for k, v in aux["grads"].items()},
                loss=float(aux["terms"]["total"]), psnr=float(aux["psnr"]),
                overflow=bool(aux["overflow"]),
                visibility=aux["visibility"].numpy().copy(),
                view_pos_grad_norm=aux["view_pos_grad_norm"].numpy().copy(),
                view_visibility=aux["view_visibility"].numpy().copy())


def four_ranks(rank, out_dir):
    """Every scenario of a world of 4 ranks, in turn: one step at (1, 4, 1)
    and at (1, 2, 2) on view 0; the JAX golden step at (2, 2, 1) with a GS
    strategy (its per-view accumulation); the overflow growth at (2, 2, 1);
    the DPTrainer end to end at (2, 2, 1) with GS densification, a
    checkpoint at step 6, a resume to 8 and validation. Returns the rank's
    records."""
    from threedgrut_torch import golden
    from threedgrut_torch.parallel import dp
    from threedgrut_torch.parallel.trainer import DPTrainer
    from threedgrut_torch.strategy.gs import GSStrategy

    ds = dataset()
    fields = initial_fields(ds)
    rec = {}
    mesh = dp.make_mesh(1, 4, 1)
    # Bits through the int32 gather: -0.0, a NaN payload, int64, bool.
    odd = torch.tensor([-0.0, float(rank), 1e-40]).to(torch.float32)
    odd = torch.cat([odd, torch.tensor([0x7FC01234 + rank],
                                       dtype=torch.int32).view(
                                           torch.float32)])
    rec["gather"] = [x.numpy() for x in dp.all_gather(
        [odd, torch.tensor([rank - 2, 1 << 40]),
         torch.tensor([rank % 2 == 0, True])],
        mesh.groups["tile"], 4, rank)]
    for shape in ((1, 4, 1), (1, 2, 2)):
        tr = DPTrainer(config(), ds, params=params_of(fields), device="cpu",
                       mesh_shape=shape)
        aux = tr.train_step(ds[0])
        rec[shape] = dict(step_record(aux), coords=tr.mesh.coords,
                          digest=digest(state_of(tr)))

    g = golden.load_dp()
    gfields = {k.split("/", 1)[1]: g[k] for k in g if k.startswith("params/")}
    cfg = golden_config()
    tr = DPTrainer(cfg, ds, params=params_of(gfields), device="cpu",
                   mesh_shape=(2, 2, 1),
                   strategy=GSStrategy(cfg.strategy, 64, "cpu"))
    tr.scene_extent = float(g["scene_extent"])
    aux = tr.train_step_batch(golden_views(ds, g))
    st = state_of(tr)
    rec["golden"] = dict(step_record(aux), coords=tr.mesh.coords,
                         digest=digest(st),
                         positions=st["params/positions"],
                         strategy={k: v for k, v in st.items()
                                   if k.startswith("strategy/")})

    # The 32 particles twice over (all 64 slots live), 7.4x wider: every
    # splat covers the 4 tiles, 256 intersections a view, and a capacity of
    # 128 overflows.
    cfg = config()
    cfg.render.isect_capacity = 128
    wide = {k: np.concatenate([v[:32], v[:32]]) for k, v in fields.items()}
    wide["positions"][32:] += 0.01
    wide["scale"] += 2.0
    tr = DPTrainer(cfg, ds, params=params_of(wide), device="cpu",
                   mesh_shape=(2, 2, 1))
    caps, flags = [], []
    for k in range(4):
        aux = tr.train_step_batch([ds[(2 * k) % 4], ds[(2 * k + 1) % 4]])
        caps.append(tr.isect_capacity)
        flags.append(bool(aux["overflow"]))
    rec["overflow"] = dict(capacities=caps, flags=flags,
                           digest=digest(state_of(tr)))

    cfg = config()
    cfg.strategy.densify_start = 2
    cfg.strategy.densify_end = 100
    cfg.strategy.densify_frequency = 4
    cfg.strategy.densify_grad_threshold = 1e-9
    cfg.train.checkpoint_iterations = (6,)
    cfg.train.val_frequency = 0
    tr = DPTrainer(cfg, ds, val_dataset=ds, params=params_of(fields),
                   device="cpu", mesh_shape=(2, 2, 1),
                   strategy=GSStrategy(cfg.strategy, 64, "cpu"))
    e2e = dict(psnr_before=tr.validate()["psnr"],
               alive_before=int(tr.params.num_active()))
    tr.run(iterations=8, log_every=0, out_dir=out_dir)
    st = state_of(tr)
    e2e.update(psnr_after=tr.validate()["psnr"],
               alive_after=int(tr.params.num_active()), step=tr.global_step,
               digest=digest(st), alive=st["params/alive"],
               ckpt=sorted(os.listdir(out_dir)))
    tr2 = DPTrainer.load_checkpoint(
        os.path.join(out_dir, "ckpt_6.npz"), dataset=ds, val_dataset=ds,
        device="cpu", strategy=GSStrategy(cfg.strategy, 64, "cpu"),
        mesh_shape=(2, 2, 1))
    e2e.update(resumed_at=tr2.global_step,
               resumed_accum=float(tr2.strategy.state.grad_accum.sum()))
    tr2.run(iterations=2, log_every=0)
    e2e.update(resumed_step=tr2.global_step,
               resumed_digest=digest(state_of(tr2)),
               resumed_alive=int(tr2.params.num_active()))
    rec["e2e"] = e2e
    return rec
