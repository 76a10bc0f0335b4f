"""The train-step slice of the PyTorch port against the JAX package on the
same numpy inputs (CPU): losses and SSIM, Adam and SelectiveAdam, one train
step and one eval step of the trainer against JAX's _step_fn, training
that raises PSNR, checkpoints that resume across the two packages, the
config tree, init_from_points and the dataset helpers.

Tolerances and why:
  * losses, SSIM, PSNR: rtol 1e-5 (f32 sums in another order).
  * Adam moments: rtol 1e-6, atol 1e-9 (the same f32 operations).
    Parameters: rtol 1e-6, atol 1e-6. The bias corrections and the
    positions LR are computed in double on the host here and in f32 there;
    1 - 0.999^t in f32 is off by ~1.5e-6 relative at t = 42, which moves an
    update of the density's scale (lr 0.05) by ~4e-7.
  * train step with low_precision_grads=False: loss rtol 1e-5, image atol
    2e-4 (golden.compare's), gradients (read through the first moment,
    m = 0.1 g) atol 1e-5 x each field's max; with True, gradients atol
    2e-3 x max (bf16-rounded slot cotangents, see test_torch_backward.py).
  * updated parameters: atol 1e-6 (JAX's 1 - 0.999 in f32 is 1.3e-5 off,
    which moves a first step of lr 0.05 by ~3e-7). Adam's first step moves
    each entry by lr * sign(g), so an entry whose JAX gradient lies within
    the gradient tolerance of 0 can move the other way; they are compared
    where |g| clears it.
  * the set of particles with a nonzero gradient (the trainer's hit
    visibility): equal to JAX's on all but 0.1% of the particles.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threedgrut_tpu import optimizers as jopt
from threedgrut_tpu import trainer as jtrainer
from threedgrut_tpu.cameras import PinholeCamera as JPinhole
from threedgrut_tpu.config import Config as JConfig
from threedgrut_tpu.config import make as jmake
from threedgrut_tpu.config import to_dict as jto_dict
from threedgrut_tpu.datasets import protocols as jprot
from threedgrut_tpu.model import background as jbg
from threedgrut_tpu.model import gaussians as jg
from threedgrut_tpu.model import losses as jlosses
from threedgrut_torch import optimizers as topt
from threedgrut_torch import trainer as ttrainer
from threedgrut_torch.cameras import PinholeCamera, look_at
from threedgrut_torch.config import Config, from_dict, make, to_dict
from threedgrut_torch.datasets import protocols as tprot
from threedgrut_torch.datasets.dataset_synthetic import SyntheticDataset
from threedgrut_torch.model import background as tbg
from threedgrut_torch.model import gaussians as tg
from threedgrut_torch.model import losses as tlosses

RES = (48, 48)
CAP = 1 << 13


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread for the module (as
    tests/test_torch_grt.py): under the parallel run's load, the plain
    versions' many small ops stall on an 8-thread pool's barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand(seed, *shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(masked):
    pred, gt = rand(0, 40, 36, 3), rand(1, 40, 36, 3)
    mask = (rand(2, 40, 36, 1) > 0.3).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    jl, jterms = jlosses.total_loss(jnp.asarray(pred), jnp.asarray(gt),
                                    0.8, 0.1, 0.2, jm)
    tl, tterms = tlosses.total_loss(torch.tensor(pred), torch.tensor(gt),
                                    0.8, 0.1, 0.2, tm)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert set(tterms) == set(jterms) == {"l1", "l2", "ssim", "total"}
    for k in jterms:
        np.testing.assert_allclose(float(tterms[k]), float(jterms[k]),
                                   rtol=1e-5, err_msg=k)
    blur_j = jlosses._blur(jnp.asarray(pred), 11, 1.5)
    blur_t = tlosses._blur(torch.tensor(pred), 11, 1.5)
    np.testing.assert_allclose(blur_t.numpy(), np.asarray(blur_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.psnr(torch.tensor(pred), torch.tensor(gt))),
        float(jlosses.psnr(jnp.asarray(pred), jnp.asarray(gt))), rtol=1e-5)


def small_fields(seed=3, n=200, capacity=256):
    rng = np.random.default_rng(seed)
    return tg.padded_fields(
        rng.normal(0, 0.5, (n, 3)).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        np.log(rng.uniform(0.03, 0.12, (n, 3))).astype(np.float32),
        rng.normal(0, 1, (n, 1)).astype(np.float32),
        rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        rng.normal(0, 0.1, (n, 45)).astype(np.float32), capacity)


@pytest.mark.parametrize("selective", [False, True])
def test_adam_matches_jax(selective):
    f = small_fields()
    rng = np.random.default_rng(4)
    grads = {k: rng.normal(size=f[k].shape).astype(np.float32)
             for k in topt.PARAM_FIELDS}
    m0 = {k: rng.normal(size=f[k].shape).astype(np.float32) * 0.01
          for k in topt.PARAM_FIELDS}
    v0 = {k: np.abs(rng.normal(size=f[k].shape)).astype(np.float32) * 1e-4
          for k in topt.PARAM_FIELDS}
    vis = rng.uniform(size=f["alive"].shape) > 0.4
    cfg_j = jopt.OptimizerConfig(selective=selective, max_steps=100)
    cfg_t = topt.OptimizerConfig(selective=selective, max_steps=100)
    jp = jg.Gaussians(**{k: jnp.asarray(v) for k, v in f.items()})
    jstate = jopt.AdamState(step=jnp.int32(41),
                            exp_avg={k: jnp.asarray(v) for k, v in m0.items()},
                            exp_avg_sq={k: jnp.asarray(v)
                                        for k, v in v0.items()})
    jp2, js2 = jopt.step(jp, jp.replace(**{k: jnp.asarray(v)
                                           for k, v in grads.items()}),
                         jstate, cfg_j, 3.5, visibility=jnp.asarray(vis))
    tp = tg.from_numpy(f, device="cpu")
    tstate = topt.state_from_numpy(m0, v0, 41, "cpu")
    ts2 = topt.step(tp, {k: torch.tensor(v) for k, v in grads.items()},
                    tstate, cfg_t, 3.5, visibility=torch.tensor(vis))
    assert ts2.step == int(js2.step) == 42
    for k in topt.PARAM_FIELDS:
        for got, want, atol in ((getattr(tp, k).detach(), getattr(jp2, k),
                                 1e-6),
                                (ts2.exp_avg[k], js2.exp_avg[k], 1e-9),
                                (ts2.exp_avg_sq[k], js2.exp_avg_sq[k], 1e-9)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=atol, err_msg=k)
    if selective:
        frozen = ~vis
        assert np.array_equal(tp.positions.detach().numpy()[frozen],
                              f["positions"][frozen])
    for step in (0, 37, 100, 250):
        np.testing.assert_allclose(
            topt.positions_lr_schedule(cfg_t, 3.5, step),
            float(jopt.positions_lr_schedule(cfg_j, 3.5, jnp.float32(step))),
            rtol=1e-6)


def camera_np():
    w, h = RES
    return dict(focal=np.array([0.9 * w, 0.9 * w], np.float32),
                principal=np.array([w / 2, h / 2], np.float32),
                radial=np.zeros(6, np.float32),
                tangential=np.zeros(2, np.float32),
                thin_prism=np.zeros(4, np.float32))


def jax_step(fields, gt, low_precision, train):
    cfg = JConfig()
    cfg.render.isect_capacity = CAP
    cfg.render.low_precision_grads = low_precision
    key = jtrainer._register_cfg(cfg)
    params = jg.Gaussians(**{k: jnp.asarray(v) for k, v in fields.items()})
    T = look_at(np.array([0.5, -3.0, 1.0], np.float32),
                np.zeros(3, np.float32), np.array([0, 0, 1.0], np.float32))
    return jtrainer._step_fn(
        params, jopt.init(params), jnp.asarray(T),
        JPinhole(**{k: jnp.asarray(v) for k, v in camera_np().items()}),
        jnp.asarray(gt), jnp.ones(RES[::-1] + (1,)), jax.random.PRNGKey(0),
        4.0, RES, 3, key, train=train, isect_capacity=CAP)


def torch_step(fields, gt, low_precision, train):
    cfg = Config()
    cfg.render.isect_capacity = CAP
    cfg.render.low_precision_grads = low_precision
    params = tg.from_numpy(fields, device="cpu")
    T = look_at(np.array([0.5, -3.0, 1.0], np.float32),
                np.zeros(3, np.float32), np.array([0, 0, 1.0], np.float32))
    opt, aux = ttrainer.step_fn(
        params, topt.init(params), torch.tensor(T),
        PinholeCamera(**{k: torch.tensor(v) for k, v in camera_np().items()}),
        torch.tensor(gt), torch.ones(RES[::-1] + (1,)), 4.0, RES, 3, cfg,
        train=train, isect_capacity=CAP)
    return params, opt, aux


@pytest.mark.parametrize("low_precision", [False, True])
def test_train_step_matches_jax(low_precision):
    """One train step from the same numpy parameters: loss, image, the
    gradient of each field, the updated parameters and moments, and the
    hit visibility (the fused compact path, the config's default)."""
    fields = small_fields()
    gt = rand(5, RES[1], RES[0], 3)
    jp, jo, jaux = jax_step(fields, gt, low_precision, train=True)
    tp, to, taux = torch_step(fields, gt, low_precision, train=True)
    np.testing.assert_allclose(float(taux["terms"]["total"]),
                               float(jaux["terms"]["total"]), rtol=1e-5)
    assert to.step == int(jo.step) == 1
    gtol = 2e-3 if low_precision else 1e-5
    for k in topt.PARAM_FIELDS:
        m_j = np.asarray(jo.exp_avg[k])
        g_j = m_j / np.float32(0.1)
        atol = gtol * np.abs(g_j).max()
        np.testing.assert_allclose(taux["grads"][k].numpy(), g_j, rtol=1e-5,
                                   atol=atol, err_msg=k)
        np.testing.assert_allclose(to.exp_avg[k].numpy(), m_j, rtol=1e-5,
                                   atol=0.1 * atol, err_msg=k)
        # v = 0.001 g^2: compared as the |g| it implies.
        np.testing.assert_allclose(
            np.sqrt(to.exp_avg_sq[k].numpy() / np.float32(1e-3)),
            np.sqrt(np.asarray(jo.exp_avg_sq[k]) / np.float32(1e-3)),
            rtol=1e-5, atol=atol, err_msg=k)
        clear = np.abs(g_j) > 2 * atol
        assert clear.any(), k
        np.testing.assert_allclose(
            getattr(tp, k).detach().numpy()[clear],
            np.asarray(getattr(jp, k))[clear], rtol=1e-5, atol=1e-6,
            err_msg=k)
    vis_t = taux["visibility"].numpy()
    vis_j = np.asarray(jaux["visibility"])
    assert (vis_t != vis_j).sum() <= max(1, int(1e-3 * vis_t.size))
    assert 0 < vis_t.sum() < 200            # 200 live particles of 256
    if not low_precision:
        # The image (the forward is the eval step's) and eval visibility.
        _, _, jeval = jax_step(fields, gt, False, train=False)
        _, _, teval = torch_step(fields, gt, False, train=False)
        np.testing.assert_allclose(taux["pred"].numpy(),
                                   np.asarray(jeval["pred"]), rtol=1e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(float(teval["psnr"]),
                                   float(jeval["psnr"]), rtol=1e-5)
        ve_t = teval["visibility"].numpy()
        ve_j = np.asarray(jeval["visibility"])
        assert (ve_t != ve_j).sum() <= max(1, int(1e-3 * ve_t.size))


@pytest.fixture(scope="module")
def dataset():
    return SyntheticDataset(num_views=6, resolution=(32, 32),
                            num_gt_gaussians=48, seed=3, device="cpu")


def make_trainer(dataset, **overrides):
    cfg = Config()
    cfg.render.isect_capacity = 1 << 14
    cfg.model.progressive_sh_interval = 10
    for k, v in overrides.items():
        from threedgrut_torch.config import apply_override
        apply_override(cfg, f"{k}={v}")
    pts = np.asarray(dataset.scene[0]) + np.random.default_rng(7).normal(
        0, 0.05, dataset.scene[0].shape).astype(np.float32)
    params = tg.init_from_points(pts, capacity=64, device="cpu")
    return ttrainer.Trainer(cfg, dataset, val_dataset=dataset, params=params,
                            device="cpu")


def test_training_improves_psnr(dataset):
    tr = make_trainer(dataset)
    before = tr.validate()["psnr"]
    tr.run(iterations=60, log_every=0)
    after = tr.validate()["psnr"]
    assert after > before + 1.0, (before, after)
    assert tr.active_sh_degree() == 3 and tr.global_step == 60


def test_selective_adam_freezes_invisible(dataset):
    tr = make_trainer(dataset, **{"optimizer.selective": "true"})
    p0 = tr.params.positions.detach().clone()
    aux = tr.train_step(dataset[0])
    vis = aux["visibility"]
    moved = (tr.params.positions.detach() - p0).abs().sum(-1) > 0
    assert 0 < int(vis.sum()) < 64
    assert not bool(moved[~vis].any())


def test_checkpoints_resume_across_packages(tmp_path, dataset):
    """A checkpoint of the JAX Trainer resumes in the port, and the port's
    resumes in the JAX Trainer: parameters, moments and counters."""
    fields = small_fields(seed=9, n=50, capacity=64)
    rng = np.random.default_rng(10)
    m = {k: rng.normal(size=fields[k].shape).astype(np.float32)
         for k in topt.PARAM_FIELDS}
    v = {k: np.abs(rng.normal(size=fields[k].shape)).astype(np.float32)
         for k in topt.PARAM_FIELDS}
    cfg = JConfig()
    cfg.render.isect_capacity = 1 << 14
    jt = jtrainer.Trainer(cfg, dataclasses.make_dataclass(
        "Extent", [("scene_extent", float)])(3.0),
        params=jg.Gaussians(**{k: jnp.asarray(x) for k, x in fields.items()}))
    jt.opt_state = jopt.AdamState(
        step=jnp.int32(7), exp_avg={k: jnp.asarray(x) for k, x in m.items()},
        exp_avg_sq={k: jnp.asarray(x) for k, x in v.items()})
    jt.global_step, jt.isect_capacity = 7, 1 << 15
    path = jt.save_checkpoint(str(tmp_path / "jax"))

    tt = ttrainer.Trainer.load_checkpoint(path, dataset, device="cpu")
    assert (tt.global_step, tt.opt_state.step) == (7, 7)
    assert tt.isect_capacity == 1 << 15 and tt.scene_extent == 3.0
    assert to_dict(tt.cfg) == jto_dict(cfg)
    for k in tg.FIELDS:
        assert np.array_equal(getattr(tt.params, k).detach().numpy(),
                              fields[k]), k
    for k in topt.PARAM_FIELDS:
        assert np.array_equal(tt.opt_state.exp_avg[k].numpy(), m[k])
        assert np.array_equal(tt.opt_state.exp_avg_sq[k].numpy(), v[k])
    tt.train_step(dataset[0])
    path2 = tt.save_checkpoint(str(tmp_path / "torch"))

    jt2 = jtrainer.Trainer.load_checkpoint(path2)
    assert jt2.global_step == 8 and int(jt2.opt_state.step) == 8
    assert jt2.isect_capacity == 1 << 15
    for k in tg.FIELDS:
        assert np.array_equal(np.asarray(getattr(jt2.params, k)),
                              getattr(tt.params, k).detach().numpy()), k
    for k in topt.PARAM_FIELDS:
        assert np.array_equal(np.asarray(jt2.opt_state.exp_avg[k]),
                              tt.opt_state.exp_avg[k].numpy()), k


def test_config_matches_jax():
    for name in ("nerf_synthetic_3dgut", "colmap_3dgrt_mcmc",
                 "nerf_synthetic_3dgut_sorted"):
        ov = ["train.iterations=123", "render.walk_compact_fraction=0.5",
              "train.checkpoint_iterations=[10,20]"]
        assert to_dict(make(name, ov)) == jto_dict(jmake(name, ov)), name
    cfg = make("colmap_3dgut", ["strategy.method=mcmc"])
    assert cfg.strategy.densify_end == 25000
    assert to_dict(from_dict(to_dict(cfg))) == to_dict(cfg)
    with pytest.raises(KeyError):
        make("colmap_3dgut", ["render.no_such_key=1"])


def test_init_from_points_matches_jax():
    pts = rand(12, 40, 3, lo=-1.0, hi=1.0)
    obs = rand(13, 5, 3, lo=3.0, hi=4.0)
    for kw in (dict(), dict(observer_points=obs,
                            colors=rand(14, 40, 3) * 255.0)):
        j = jg.init_from_points(pts, capacity=64, seed=2, **kw)
        t = tg.init_from_points(pts, capacity=64, seed=2, device="cpu", **kw)
        for k in tg.FIELDS:
            np.testing.assert_allclose(getattr(t, k).detach().numpy(),
                                       np.asarray(getattr(j, k)), rtol=1e-6,
                                       err_msg=k)


def test_random_background_and_views():
    """The random background draws from the caller's generator in training
    only (eval is black, as in JAX); the view stream and scene extent are
    the JAX package's."""
    rgb, opa = rand(20, 8, 8, 3), rand(21, 8, 8)
    a = tbg.compose(torch.tensor(rgb), torch.tensor(opa), "random",
                    train=True, generator=torch.Generator().manual_seed(1))
    b = tbg.compose(torch.tensor(rgb), torch.tensor(opa), "random",
                    train=True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    bg = (a.numpy() - rgb) / (1.0 - opa)[..., None]
    assert 0.0 <= bg.min() and bg.max() <= 1.0 and bg.std() > 0.1
    np.testing.assert_array_equal(
        tbg.compose(torch.tensor(rgb), torch.tensor(opa), "random").numpy(),
        np.asarray(jbg.compose(jnp.asarray(rgb), jnp.asarray(opa), "random",
                               train=False)))
    with pytest.raises(ValueError, match="Generator"):
        tbg.compose(torch.tensor(rgb), torch.tensor(opa), "random",
                    train=True)
    tstream, jstream = tprot.iterate_epochs(7, 3), jprot.iterate_epochs(7, 3)
    assert [next(tstream) for _ in range(30)] == [next(jstream)
                                                  for _ in range(30)]
    cams = rand(22, 9, 3)
    assert tprot.camera_bbox_extent(cams) == jprot.camera_bbox_extent(cams)


def test_synthetic_dataset(dataset):
    from threedgrut_tpu.datasets.dataset_synthetic import (
        random_gt_scene as jscene)
    assert len(dataset) == 6
    v = dataset[2]
    assert v.rgb_gt.shape == (32, 32, 3) and v.rgb_gt.dtype == np.float32
    assert v.rgb_gt.max() > 0.2 and v.rgb_gt.min() >= 0.0
    for a, b in zip(dataset.scene, jscene(48, 3)):
        assert np.array_equal(a, b)
    assert dataset.observer_points.shape == (6, 3)
    np.testing.assert_allclose(dataset.scene_extent, tprot.camera_bbox_extent(
        dataset.observer_points))


def test_rolling_shutter_view_trains(dataset):
    """A rolling-shutter view (start and end pose) goes through the train
    step, and its eval image differs from the global-shutter one."""
    from threedgrut_torch.cameras import ShutterType
    tr = make_trainer(dataset)
    rolling = dataclasses.replace(
        dataset[0], shutter=ShutterType.ROLLING_TOP_TO_BOTTOM,
        pose_end=dataset[1].T_to_world)
    aux = tr.train_step(rolling)
    assert np.isfinite(float(aux["terms"]["total"]))
    glob = tr.eval_view(dataset[0])["pred"]
    roll = tr.eval_view(rolling)["pred"]
    assert float((glob - roll).abs().max()) > 1e-4
