"""Write threedgrut_torch/golden/dp_2x2.npz: one step of the JAX package's
data-parallel trainer, the reference the port's mesh step is held to
(tests/test_torch_parallel.py reads the file and makes no JAX call).

    python tools/torch_dp_golden.py

It runs threedgrut_tpu.parallel.dp.make_dp_train_step(debug_grads=True) on
a (data 2, tile 2, model 1) mesh of 8 virtual CPU devices, on
tests/test_parallel.py's scene (SyntheticDataset(num_views=4, resolution
32x32, 32 ground-truth Gaussians, seed 11), 64 slots initialized from its
points plus a seeded offset, isect_capacity 4096, a black background,
low_precision_grads off), views 0 and 1. It stores the step's inputs, its
gradients, loss, PSNR, per-particle position-gradient norm, visibility and
overflow flag, and a provenance hash (golden.dp_provenance) of the JAX
package's sources, the inputs and the settings below.
"""
import os
import sys
from pathlib import Path

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

# The step's settings, hashed into the provenance.
SETTINGS = dict(mesh=(2, 2, 1), views=(0, 1), resolution=(32, 32),
                num_views=4, num_gt_gaussians=32, dataset_seed=11,
                capacity=64, offset_seed=1, offset_std=0.05,
                isect_capacity=1 << 12, background_color="black",
                low_precision_grads=False, sh_degree=3, key_seed=0)


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp

    from threedgrut_tpu import optimizers
    from threedgrut_tpu.config import Config
    from threedgrut_tpu.datasets.dataset_synthetic import SyntheticDataset
    from threedgrut_tpu.model import gaussians
    from threedgrut_tpu.parallel import dp
    from threedgrut_torch import golden

    s = SETTINGS
    res = s["resolution"]
    ds = SyntheticDataset(num_views=s["num_views"], resolution=res,
                          num_gt_gaussians=s["num_gt_gaussians"],
                          seed=s["dataset_seed"])
    pts = np.asarray(ds.scene[0]) + np.random.default_rng(
        s["offset_seed"]).normal(0, s["offset_std"],
                                 ds.scene[0].shape).astype(np.float32)
    params = gaussians.init_from_points(pts, capacity=s["capacity"])
    cfg = Config()
    cfg.render.isect_capacity = s["isect_capacity"]
    cfg.model.background_color = s["background_color"]
    cfg.render.low_precision_grads = s["low_precision_grads"]
    d, t, m = s["mesh"]
    mesh = dp.make_mesh(d * t * m, tile_parallel=t, model_parallel=m)
    assert mesh.shape["data"] == d
    step = dp.make_dp_train_step(cfg, mesh, res, sh_degree=s["sh_degree"],
                                 debug_grads=True)
    views = [ds[i] for i in s["views"]]
    Ts = jnp.stack([jnp.asarray(v.T_to_world) for v in views])
    cams = jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]),
                        *[v.camera for v in views])
    gts = jnp.stack([jnp.asarray(v.rgb_gt) for v in views])
    keys = jax.random.split(jax.random.PRNGKey(s["key_seed"]), d)
    _, _, metrics = step(params, optimizers.init(params), Ts, cams, gts,
                         keys, jnp.float32(ds.scene_extent))

    inputs = {f"params/{f}": np.asarray(getattr(params, f))
              for f in ("positions", "rotation", "scale", "density",
                        "features_albedo", "features_specular", "alive")}
    inputs.update(T_to_world=np.asarray(Ts), rgb_gt=np.asarray(gts),
                  scene_extent=np.float32(ds.scene_extent))
    out = dict(inputs)
    for f, g in metrics["grads"].items():
        out[f"grads/{f}"] = np.asarray(g)
    for k in ("loss", "psnr", "pos_grad_norm", "visibility", "overflow"):
        out[k] = np.asarray(metrics[k])
    assert not bool(out["overflow"])
    out["provenance"] = np.array(golden.dp_provenance(
        ROOT / "threedgrut_tpu", inputs, SETTINGS))
    np.savez_compressed(golden.DP_PATH, **out)
    print("wrote", golden.DP_PATH, golden.DP_PATH.stat().st_size, "bytes")


if __name__ == "__main__":
    main()
