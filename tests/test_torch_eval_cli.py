"""Evaluation, metrics and the entry points of the PyTorch port against the
JAX package (CPU): Renderer.render_all on a checkpoint the JAX Trainer
wrote, the 3DGRT eval overrides, Trainer.load_checkpoint without a dataset,
MetricsWriter and jet_colormap, log_val_images' panels, and the port's
train and render entry points (`python -m threedgrut_torch.train`,
`python -m threedgrut_torch.render`) with --device cpu on a tiny NeRF scene
and, in miniature, on the multi-sensor MCMC acceptance run; and ROADMAP
C11 (the root train.py resumes without a strategy): the port's resumed run
restores its strategy's state and densifies.

Tolerances and why (those of tests/test_torch_train.py's eval step):
  * per-view prediction: rtol 1e-4, atol 2e-4 (golden.compare's; the port
    sums colours in another order and takes exp from another library);
    PSNR rtol 1e-5; SSIM atol 1e-5 (the SSIM of the same ground truth
    against two predictions that differ by <= 2e-4).
  * n_frames, overflow_views, the best and worst frames: equal.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from threedgrut_tpu import datasets as jdatasets
from threedgrut_tpu import render_eval as jrender_eval
from threedgrut_tpu import trainer as jtrainer
from threedgrut_tpu.config import Config as JConfig
from threedgrut_tpu.config import to_dict as jto_dict
from threedgrut_tpu.model import gaussians as jg
from threedgrut_tpu.model import losses as jlosses
from threedgrut_tpu.utils import writer as jwriter
from threedgrut_torch import api as tapi
from threedgrut_torch import datasets as tdatasets
from threedgrut_torch import render_eval as trender_eval
from threedgrut_torch import train as ttrain
from threedgrut_torch import trainer as ttrainer
from threedgrut_torch.cameras import matrix_to_quat
from threedgrut_torch.config import preset_3dgrt, to_dict
from threedgrut_torch.datasets import colmap as tcolmap
from threedgrut_torch.model import gaussians as tg
from threedgrut_torch.model import losses as tlosses
from threedgrut_torch.render import __main__ as trender_cli
from threedgrut_torch.utils import writer as twriter

RES = 32


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    """torch on one intra-op thread (the plain versions' many small ops
    stall an 8-thread pool under the parallel test run's load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def save_png(path, arr):
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def nerf_dir(tmp_path_factory):
    """A NeRF-synthetic scene: 32x32 RGBA frames, 4 train and 2 test, the
    cameras at z = 4 looking down at the origin."""
    d = tmp_path_factory.mktemp("nerf_eval")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("test", 2)):
        os.makedirs(d / split)
        frames = []
        for i in range(n):
            save_png(d / split / f"r_{i}.png",
                     rng.uniform(size=(RES, RES, 4)).astype(np.float32))
            c2w = np.eye(4)
            c2w[:3, 3] = [0.15 * i - 0.1, 0.05 * i, 4.0]
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(d / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    return str(d)


def small_fields(seed=3, n=200, capacity=256):
    rng = np.random.default_rng(seed)
    return tg.padded_fields(
        rng.normal(0, 0.5, (n, 3)).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        np.log(rng.uniform(0.03, 0.12, (n, 3))).astype(np.float32),
        rng.normal(0, 1, (n, 1)).astype(np.float32),
        rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        rng.normal(0, 0.1, (n, 45)).astype(np.float32), capacity)


@pytest.fixture(scope="module")
def jax_checkpoint(nerf_dir, tmp_path_factory):
    """A checkpoint written by the JAX Trainer (200 particles in 256 slots,
    global step 5, a grown capacity)."""
    cfg = JConfig()
    cfg.render.isect_capacity = 1 << 13
    cfg.dataset.path = nerf_dir
    ds = jdatasets.make("nerf", nerf_dir)
    jt = jtrainer.Trainer(cfg, ds, params=jg.Gaussians(
        **{k: jnp.asarray(v) for k, v in small_fields().items()}))
    jt.global_step, jt.isect_capacity = 5, 1 << 14
    return jt.save_checkpoint(str(tmp_path_factory.mktemp("jax_ckpt")))


def test_load_checkpoint_without_dataset(jax_checkpoint, nerf_dir):
    """A trainer with no dataset from the JAX Trainer's checkpoint: the
    scene extent, parameters, moments, counters and config are the
    checkpoint's, as the JAX Trainer's are."""
    tt = ttrainer.Trainer.load_checkpoint(jax_checkpoint, device="cpu")
    jt = jtrainer.Trainer.load_checkpoint(jax_checkpoint, dataset=None)
    assert tt.dataset is None and jt.dataset is None
    assert tt.scene_extent == jt.scene_extent == \
        jdatasets.make("nerf", nerf_dir).scene_extent
    assert (tt.global_step, tt.isect_capacity) == (5, 1 << 14)
    assert (jt.global_step, jt.isect_capacity) == (5, 1 << 14)
    assert tt.opt_state.step == int(jt.opt_state.step) == 0
    assert to_dict(tt.cfg) == jto_dict(jt.cfg)
    for k in tg.FIELDS:
        assert np.array_equal(getattr(tt.params, k).detach().numpy(),
                              np.asarray(getattr(jt.params, k))), k
    assert tt.strategy is None and tt.writer is None


def test_render_all_matches_jax(jax_checkpoint, nerf_dir, tmp_path):
    """Renderer.render_all of both packages on the JAX checkpoint: the
    summary and, view by view, the prediction, PSNR and SSIM."""
    tds = tdatasets.make("nerf", nerf_dir, split="test")
    jds = jdatasets.make("nerf", nerf_dir, split="test")
    tr = trender_eval.Renderer.from_checkpoint(jax_checkpoint, tds,
                                               device="cpu")
    jr = jrender_eval.Renderer.from_checkpoint(jax_checkpoint, jds)
    ts = tr.render_all(out_dir=str(tmp_path / "t"), save_gt=True)
    js = jr.render_all(out_dir=str(tmp_path / "j"), save_gt=True)
    for k in ("n_frames", "overflow_views", "best_psnr_idx",
              "worst_psnr_idx"):
        assert ts[k] == js[k], k
    assert ts["n_frames"] == 2 and ts["best_psnr_idx"] != \
        ts["worst_psnr_idx"]
    np.testing.assert_allclose(ts["psnr"], js["psnr"], rtol=1e-5)
    np.testing.assert_allclose(ts["ssim"], js["ssim"], rtol=0, atol=1e-5)
    assert "lpips" not in ts and "lpips" not in js  # no torchmetrics
    assert ts["mean_render_s"] > 0.0
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    for i in range(len(tds)):
        ta = tr.trainer.eval_view(tds[i])
        ja = jr.trainer.eval_view(jds[i])
        np.testing.assert_allclose(ta["pred"].numpy(), np.asarray(ja["pred"]),
                                   rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(float(ta["psnr"]), float(ja["psnr"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(
            float(tlosses.ssim(ta["pred"], torch.tensor(tds[i].rgb_gt))),
            float(jlosses.ssim(ja["pred"], jnp.asarray(jds[i].rgb_gt))),
            rtol=0, atol=1e-5)


def test_grt_eval_overrides(nerf_dir, tmp_path):
    """A 3DGRT checkpoint: Renderer.from_checkpoint applies the eval
    minimum transmittance and density clamping as the JAX Renderer does,
    and renders the test split."""
    cfg = preset_3dgrt()
    cfg.render.isect_capacity = 1 << 15
    ds = tdatasets.make("nerf", nerf_dir, split="test")
    tt = ttrainer.Trainer(cfg, ds, params=tg.from_numpy(small_fields(),
                                                        device="cpu"),
                          device="cpu")
    path = tt.save_checkpoint(str(tmp_path))
    tr = trender_eval.Renderer.from_checkpoint(path, ds, device="cpu")
    jr = jrender_eval.Renderer.from_checkpoint(
        path, jdatasets.make("nerf", nerf_dir, split="test"))
    assert to_dict(tr.trainer.cfg) == jto_dict(jr.trainer.cfg)
    assert tr.trainer.cfg.render.min_transmittance == 0.03
    assert tr.trainer.cfg.render.particle_kernel_density_clamping
    assert cfg.render.min_transmittance == 0.001   # the saved config
    summary = tr.render_all(compute_lpips=False)
    assert summary["n_frames"] == 2 and summary["overflow_views"] == 0
    assert np.isfinite(summary["psnr"]) and 0 < summary["ssim"] <= 1


def test_metrics_writer_matches_jax(tmp_path):
    tw = twriter.MetricsWriter(str(tmp_path), "t")
    jw = jwriter.MetricsWriter(str(tmp_path), "j")
    for w, tensor in ((tw, torch.tensor(2.5)), (jw, jnp.float32(2.5))):
        w.scalars({"a": 1.25, "b": tensor, "c": "text", "d": None}, 3,
                  prefix="train/")
        w.scalar("val/psnr", 21.5, 7)
        w.image("val_0/pred", np.full((4, 5, 3), 0.5, np.float32), 7)
        w.close()

    def lines(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            return [{k: v for k, v in json.loads(ln).items() if k != "t"}
                    for ln in f]

    assert lines("t") == lines("j") == [
        {"step": 3, "train/a": 1.25}, {"step": 3, "train/b": 2.5},
        {"step": 7, "val/psnr": 21.5}]
    assert any(f.startswith("events.out.tfevents")   # tensorboard imports
               for f in os.listdir(tmp_path / "t"))
    x = np.linspace(-0.2, 1.2, 57).reshape(3, 19)
    assert np.array_equal(twriter.jet_colormap(x), jwriter.jet_colormap(x))


class _Recorder:
    def __init__(self):
        self.images = []

    def image(self, tag, img, step):
        self.images.append((tag, img.shape, step))


class _Views:
    """`n` copies of one view (a dataset for the panels' view ids)."""

    def __init__(self, view, n, extent):
        self.view, self.n, self.scene_extent = view, n, extent

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.view


def test_log_val_images_matches_jax(nerf_dir):
    """The panels' tags, shapes and step at the fixed view ids (0 and 13
    of 14 views), against the JAX Trainer's with its eval stubbed."""
    ds = tdatasets.make("nerf", nerf_dir, split="test")
    views = _Views(ds[0], 14, ds.scene_extent)
    tt = ttrainer.Trainer(ttrainer.Config(), views, val_dataset=views,
                          params=tg.from_numpy(small_fields(), device="cpu"),
                          device="cpu", writer=_Recorder())
    tt.global_step = 9
    tt.log_val_images()

    jds = jdatasets.make("nerf", nerf_dir, split="test")
    jviews = _Views(jds[0], 14, jds.scene_extent)
    jt = jtrainer.Trainer(JConfig(), jviews, val_dataset=jviews,
                          writer=_Recorder())
    jt.global_step = 9
    hw = (RES, RES)
    jt.eval_view = lambda view: dict(
        pred=np.zeros(hw + (3,)), hit_count=np.ones(hw),
        depth=np.ones(hw), opacity=np.ones(hw))
    jt.log_val_images()
    assert tt.writer.images == jt.writer.images
    assert [t for t, _, _ in tt.writer.images] == [
        f"val_{i}/{p}" for i in (0, 13) for p in
        ("pred", "gt", "hits_jet", "inv_depth_jet", "opacity")]


def test_train_and_render_entry_points(nerf_dir, tmp_path):
    """python -m threedgrut_torch.train / .render with --device cpu on the
    NeRF scene: checkpoints, metrics, the final export (export_last.ply,
    .ingp and .usdz; the PLY loads back through api.load_scene as the last
    checkpoint's alive rows), the final test renders, then the render
    entry on the last checkpoint. Without a card, the default device
    raises. --multichip 1,1,1 over gloo trains the same run on a mesh of one
    process, bit for bit (its last checkpoint equals the run's); a shape
    that is not D,T,M and a 3DGRT method on the mesh are refused (the
    meshes of several ranks: tests/test_torch_parallel.py). --with-gui is
    ported: tests/test_torch_viewer.py trains with it."""
    out = str(tmp_path)
    args = ["--device", "cpu", "--config-name", "nerf_synthetic_3dgut",
            f"path={nerf_dir}", f"out_dir={out}", "experiment_name=t",
            "train.iterations=4", "train.val_frequency=2",
            "train.checkpoint_iterations=[2]", "render.isect_capacity=16384",
            "model.capacity=2048"]
    assert ttrain.main(args) == 0
    run = os.path.join(out, "t")
    for f in ("ckpt_2.npz", "ckpt_2.json", "ckpt_last.npz",
              "export_last.ply", "export_last.ingp", "export_last.usdz",
              "test_renders/pred_0000.png", "test_renders/pred_0001.png"):
        assert os.path.exists(os.path.join(run, f)), f
    back = tapi.load_scene(os.path.join(run, "export_last.ply"),
                           device="cpu")
    with np.load(os.path.join(run, "ckpt_last.npz")) as last:
        alive = last["params/alive"]
        n = int(alive.sum())
        assert int(back.num_active()) == n
        for f in tg.FIELDS[:-1]:
            assert np.array_equal(getattr(back, f).detach().numpy()[:n],
                                  last[f"params/{f}"][alive]), f
    with open(os.path.join(run, "metrics.jsonl")) as fh:
        rows = [json.loads(ln) for ln in fh]
    tags = {(r["step"], k) for r in rows for k in r if k not in ("t",
                                                                 "step")}
    assert {(2, "val/psnr"), (4, "val/ssim"), (4, "test/psnr"),
            (4, "test/n_frames")} <= tags
    cfg = json.load(open(os.path.join(run, "ckpt_last.json")))
    assert cfg["dataset"]["type"] == "nerf"
    assert cfg["strategy"]["method"] == "gs"

    assert trender_cli.main(["--device", "cpu", "--checkpoint",
                             os.path.join(run, "ckpt_last.npz"),
                             "--out-dir", os.path.join(out, "r")]) == 0
    assert sorted(f for f in os.listdir(os.path.join(out, "r"))
                  if f.startswith("pred_")) == ["pred_0000.png",
                                                "pred_0001.png"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.main(args[2:])
    margs = ["--multichip=1,1,1", "--dist-backend", "gloo"] + [
        "experiment_name=m" if a == "experiment_name=t" else a for a in args]
    assert ttrain.main(margs) == 0
    with np.load(os.path.join(run, "ckpt_last.npz")) as last, \
            np.load(os.path.join(out, "m", "ckpt_last.npz")) as mesh_last:
        assert sorted(last.files) == sorted(mesh_last.files)
        for k in last.files:
            assert np.array_equal(last[k], mesh_last[k]), k
    with pytest.raises(SystemExit):
        ttrain.main(["--multichip=2,1"] + args)
    with pytest.raises(ValueError, match=r"'3dgrt'.*\(2, 1, 1\)"):
        ttrain.main(["--multichip=2,1,1", "--dist-backend", "gloo"] + args
                    + ["render.method=3dgrt"])


def test_multi_sensor_acceptance_in_miniature(tmp_path):
    """tests/test_cli_accept.py's pipeline at 32x32 and 4 iterations: the
    MCMC preset on the multi-sensor rig (fisheye, rolling shutter, masks),
    then the render entry rebuilding the scene from the checkpoint's
    config."""
    out = str(tmp_path)
    assert ttrain.main([
        "--device", "cpu", "--config-name", "nerf_synthetic_3dgut_mcmc",
        "dataset.type=synthetic", "dataset.synthetic_views=4",
        "dataset.synthetic_resolution=32", "dataset.synthetic_gt=48",
        "dataset.synthetic_multi_sensor=True", "train.iterations=4",
        "train.val_frequency=4", "render.isect_capacity=8192",
        "model.capacity=4096", f"out_dir={out}",
        "experiment_name=accept"]) == 0
    run = os.path.join(out, "accept")
    cfg = json.load(open(os.path.join(run, "ckpt_last.json")))
    assert cfg["dataset"]["synthetic_multi_sensor"] is True
    assert cfg["strategy"]["method"] == "mcmc"
    summary = trender_cli.run(["--device", "cpu", "--checkpoint",
                               os.path.join(run, "ckpt_last.npz"),
                               "--out-dir", os.path.join(run, "eval")])
    assert summary["n_frames"] == 4 and np.isfinite(summary["psnr"])
    preds = sorted(f for f in os.listdir(os.path.join(run, "eval"))
                   if f.startswith("pred_"))
    assert len(preds) == 4
    img = np.asarray(Image.open(os.path.join(run, "eval", preds[1])))
    assert img.shape == (32, 32, 3)


def write_colmap_scene(d, n_images=6, size=16, n_points=50, seed=2):
    """A COLMAP scene (one PINHOLE camera, an orbit of images, n_points
    points) with its model in binary under sparse/0."""
    from threedgrut_torch.datasets.dataset_synthetic import orbit_poses
    os.makedirs(d / "sparse" / "0")
    os.makedirs(d / "images")
    rng = np.random.default_rng(seed)
    cams = {1: tcolmap.ColmapCamera("PINHOLE", size, size,
                                    np.array([18.0, 18.0, 8.0, 8.0]))}
    images = {}
    for i, T in enumerate(orbit_poses(n_images, radius=3.0)):
        R_w2c = T[:3, :3].T
        q = matrix_to_quat(torch.tensor(R_w2c)).numpy().astype(np.float64)
        t = (-R_w2c @ T[:3, 3]).astype(np.float64)
        name = f"img_{i:03d}.png"
        images[i + 1] = tcolmap.ColmapImage(q, t, 1, name)
        save_png(d / "images" / name, rng.uniform(size=(size, size, 3)))
    pts = rng.normal(0, 0.5, size=(n_points, 3)).astype(np.float32)
    cols = rng.uniform(size=(n_points, 3)).astype(np.float32)
    tcolmap.write_cameras_bin(str(d / "sparse/0/cameras.bin"), cams)
    tcolmap.write_images_bin(str(d / "sparse/0/images.bin"), images)
    tcolmap.write_points3d_bin(str(d / "sparse/0/points3D.bin"), pts, cols)


def test_c11_resumed_run_restores_its_strategy_and_densifies(
        tmp_path, monkeypatch):
    """ROADMAP C11: the root train.py resumes without a strategy. The
    port's train entry builds the strategy from strategy.method before the
    checkpoint loads: the resumed run starts from the checkpoint's
    strategy/ state and densifies at its next event."""
    write_colmap_scene(tmp_path / "scene")
    common = ["--device", "cpu", "--config-name", "colmap_3dgut",
              f"path={tmp_path / 'scene'}", f"out_dir={tmp_path}",
              "render.isect_capacity=16384", "model.capacity=256",
              "train.val_frequency=0", "strategy.densify_start=1",
              "strategy.densify_frequency=3", "strategy.densify_end=100",
              "strategy.densify_grad_threshold=0.0"]
    first, _ = ttrain.run(common + ["experiment_name=a",
                                    "train.iterations=3",
                                    "train.checkpoint_iterations=[2]"])
    ckpt = str(tmp_path / "a" / "ckpt_2.npz")
    with np.load(ckpt) as data:
        saved = {k.split("/")[1]: data[k] for k in data.files
                 if k.startswith("strategy/")}
        alive_at_2 = int(data["params/alive"].sum())
    assert set(saved) == {"grad_accum", "grad_denom", "rolling_vis"}
    assert saved["grad_denom"].sum() > 0 and alive_at_2 == 50

    seen = {}
    run = ttrainer.Trainer.run

    def spy(self, *a, **kw):
        seen["state"] = {f.name: getattr(self.strategy.state, f.name).clone()
                         for f in dataclasses.fields(self.strategy.state)}
        seen["step"] = self.global_step
        return run(self, *a, **kw)

    monkeypatch.setattr(ttrainer.Trainer, "run", spy)
    tr, _ = ttrain.run(common + ["experiment_name=b", "train.iterations=1",
                                 f"resume={ckpt}"])
    assert seen["step"] == 2 and tr.global_step == 3
    assert type(tr.strategy).__name__ == "GSStrategy"
    for k, v in saved.items():
        assert np.array_equal(seen["state"][k].numpy(), v), k
    # Step 3 is a densify event: it ran, and grew the scene into free
    # slots.
    assert set(tr.strategy.counts) == {"clone", "split", "prune"}
    assert int(tr.strategy.counts["clone"] + tr.strategy.counts["split"]) \
        > 0
    assert int(tr.params.num_active()) > alive_at_2


def test_logger_matches_jax(capsys):
    """The plain (non-rich) console output of both packages' loggers, and
    the tracked tasks' registry."""
    from threedgrut_tpu.utils.logger import Logger as JLogger
    from threedgrut_torch.utils.logger import Logger as TLogger
    outs = []
    for cls in (TLogger, JLogger):
        log = cls(use_rich=False)
        log.info("step 10")
        log.warning("overflow")
        log.rule("eval")
        log.table("summary", {"psnr": 21.5, "n_frames": 8})
        log.start_task("render")
        assert log.end_task("render") >= 0.0
        assert set(log.elapsed()) == {"render"}
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "WARNING: overflow" in outs[0] and "===== eval =====" in outs[0]


def test_timers_match_jax():
    """ScopedTimer into the module registry (and into one of the caller's),
    timings_summary's keys and counts as the JAX package's; DeviceTimer
    returns the call's result and keeps a window of samples."""
    from threedgrut_tpu.utils import timer as jtimer
    from threedgrut_torch.utils import timer as ttimer
    for mod in (ttimer, jtimer):
        mod.reset_timings()
        for _ in range(3):
            with mod.ScopedTimer("data"):
                pass
        with mod.ScopedTimer("step"):
            pass
        with mod.ScopedTimer("off", enabled=False):
            pass
    tsum, jsum = ttimer.timings_summary(), jtimer.timings_summary()
    assert {k: v["count"] for k, v in tsum.items()} == \
        {k: v["count"] for k, v in jsum.items()} == {"data": 3, "step": 1}
    assert set(tsum["data"]) == set(jsum["data"])
    own = ttimer.TimingRegistry()
    with ttimer.ScopedTimer("x", registry=own):
        pass
    assert set(own.summary()) == {"x"} and "x" not in ttimer.timings_summary()
    ttimer.reset_timings()
    jtimer.reset_timings()
    dt = ttimer.DeviceTimer("cpu", window=2)
    for k in range(3):
        assert dt.measure(lambda a, b: a + b, k, 1) == k + 1
    assert len(dt.samples) == 2 and dt.mean_ms >= 0.0
