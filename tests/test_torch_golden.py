"""The golden image of threedgrut_torch/golden/ stays what the JAX reference
renders, and the port on the CPU reproduces it.

Run as `python -m tests.test_torch_golden` to rewrite the stored file."""
import numpy as np
import jax.numpy as jnp
import torch

from threedgrut_tpu import api as japi
from threedgrut_tpu.cameras import PinholeCamera as JPinhole
from threedgrut_tpu.cameras import pose_from_matrix as jpose
from threedgrut_tpu.model.gaussians import Gaussians as JGaussians
from threedgrut_torch import api as tapi
from threedgrut_torch import golden
from threedgrut_torch.cameras import example_camera, pose_from_matrix
from threedgrut_torch.model.gaussians import from_numpy


def render_golden_jax():
    """JAX api.render outputs (hit_visibility=True) of the golden scene."""
    f = golden.scene()
    params = JGaussians(**{k: jnp.asarray(v) for k, v in f.items()})
    w, h = golden.RESOLUTION
    cam = JPinhole(focal=jnp.asarray([0.9 * w, 0.9 * w], jnp.float32),
                   principal=jnp.asarray([w / 2, h / 2], jnp.float32),
                   radial=jnp.zeros(6), tangential=jnp.zeros(2),
                   thin_prism=jnp.zeros(4))
    out, overflow = japi.render(
        params, cam, jpose(jnp.asarray(golden.camera_to_world())),
        golden.RESOLUTION, isect_capacity=golden.ISECT_CAPACITY,
        hit_visibility=True)
    assert not bool(overflow)
    return {k: np.asarray(getattr(out, k)) for k in golden.OUTPUTS}


def test_golden_file_matches_jax():
    """Regenerate with JAX: the stored file is still the reference's output
    (same machine class, same XLA CPU math: 1e-6 absolute)."""
    fresh = render_golden_jax()
    stored = golden.load()
    for k in golden.OUTPUTS:
        assert stored[k].shape == fresh[k].shape, k
        np.testing.assert_allclose(stored[k].astype(np.float32),
                                   fresh[k].astype(np.float32), atol=1e-6,
                                   err_msg=k)
    # A golden frame that shows nothing would hold nothing.
    assert (stored["opacity"] > 0.1).mean() > 0.05


def test_port_matches_golden_on_cpu():
    """The port's plain path reproduces the stored JAX frame, within the
    tolerances of golden.compare."""
    params = from_numpy(golden.scene(), device="cpu")
    T = torch.as_tensor(golden.camera_to_world())
    with torch.no_grad():
        out, overflow = tapi.render(
            params, example_camera(golden.RESOLUTION, "cpu"),
            pose_from_matrix(T), golden.RESOLUTION,
            isect_capacity=golden.ISECT_CAPACITY, hit_visibility=True,
            device="cpu")
    assert not bool(overflow)
    rep, ok = golden.compare(out, golden.load())
    assert ok, rep


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    outs = render_golden_jax()
    np.savez_compressed(golden.PATH, **outs)
    print("wrote", golden.PATH, golden.PATH.stat().st_size, "bytes")
