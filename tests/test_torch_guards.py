"""Guards of the PyTorch port: it never imports JAX, the JAX package or
msgpack (the exporters carry their own coder), importing it builds
nothing, and its entry points refuse to fall back to the CPU when a card
was asked for and none is present."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from threedgrut_torch import api
from threedgrut_torch.cameras import example_camera, pose_from_matrix
from threedgrut_torch.model import gaussians
from threedgrut_torch.render import infer

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "threedgrut_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "threedgrut_tpu",
                                "msgpack"), (
                f"{path.name}:{node.lineno} imports {name}")


def test_port_runs_without_jax():
    """With jax and the JAX package made unimportable, the port imports
    and renders on the CPU, and no kernel was built or loaded."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'threedgrut_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from threedgrut_torch import api, golden\n"
        "from threedgrut_torch.cameras import example_camera, "
        "pose_from_matrix\n"
        "from threedgrut_torch.model.gaussians import from_numpy\n"
        "from threedgrut_torch.ops import cuda_build\n"
        "p = from_numpy(golden.scene(), device='cpu')\n"
        "with torch.no_grad():\n"
        "    out, ovf = api.render(\n"
        "        p, example_camera(golden.RESOLUTION, 'cpu'),\n"
        "        pose_from_matrix(torch.tensor(golden.camera_to_world())),\n"
        "        golden.RESOLUTION, isect_capacity=golden.ISECT_CAPACITY,\n"
        "        device='cpu', hit_visibility=True)\n"
        "assert not bool(ovf) and float(out.opacity.max()) > 0.5\n"
        "assert not cuda_build._loaded and not cuda_build.launches\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().endswith("ok")


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """The default device is the card; with none present every entry point
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    fields = gaussians.padded_fields(
        rng.normal(size=(8, 3)).astype(np.float32),
        rng.normal(size=(8, 4)).astype(np.float32),
        np.full((8, 3), -2.0, np.float32), np.zeros((8, 1), np.float32),
        np.zeros((8, 3), np.float32), np.zeros((8, 45), np.float32), 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gaussians.from_numpy(fields)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example_camera((32, 32))
    params = gaussians.from_numpy(fields, device="cpu")
    pose = pose_from_matrix(torch.eye(4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.render(params, example_camera((32, 32), "cpu"), pose, (32, 32),
                   isect_capacity=1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.render(params, example_camera((32, 32), "cpu"), pose, (32, 32),
                   method="3dgrt", isect_capacity=1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.trace(params, np.zeros((256, 3), np.float32),
                  np.ones((256, 3), np.float32))
    for ext in ("npz", "ply", "ingp"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.load_scene(str(ROOT / f"missing.{ext}"))
    acts = (params.get_positions(), params.get_rotation(),
            params.get_scale(), params.get_density(), params.get_features())
    cam = example_camera((32, 32), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.refresh(*acts, cam, pose, (32, 32), 1024, 16)
    scene = infer.compact_visible(*acts, torch.ones(16, dtype=torch.bool),
                                  16, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.compact_visible(*acts, torch.ones(16, dtype=torch.bool), 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.render_compact(scene, cam, pose, (32, 32), 1024)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.capture_binning(scene, cam, pose, (32, 32), 1024)
    frozen = infer.capture_binning(scene, cam, pose, (32, 32), 1024,
                                   device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        infer.render_frozen(scene, frozen, cam, pose, (32, 32))


def test_playground_entry_refuses_a_missing_card(monkeypatch):
    """`python -m threedgrut_torch.playground --device cuda` (the default)
    raises without a card instead of rendering on the CPU."""
    from threedgrut_torch.playground import __main__ as playground_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--gs_object", str(ROOT / "missing.ply")],
                 ["--gs_object", str(ROOT / "missing.ply"), "--device",
                  "cuda", "--no-serve"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            playground_cli.main(argv)


def test_strategies_refuse_a_missing_card(monkeypatch):
    """The densification strategies keep their state on the card by
    default; with none present they raise instead of using the CPU."""
    from threedgrut_torch.config import Config
    from threedgrut_torch.strategy import gs, mcmc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gs.GSStrategy(cfg.strategy, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mcmc.MCMCStrategy(cfg.strategy, cfg.optimizer, 16)


def test_mesh_refuses_a_missing_card(monkeypatch, tmp_path):
    """The mesh trainer and `--multichip` default to the card and raise
    without one (before any rank starts); a spawned rank keeps the device
    its caller asked for (cuda:(rank % card count), or the CPU). The packed
    3DGRT culls run where the trace does: on the card by default."""
    from threedgrut_torch import train as ttrain
    from threedgrut_torch.config import Config
    from threedgrut_torch.parallel import multihost
    from threedgrut_torch.parallel.trainer import DPTrainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DPTrainer(Config(), None, mesh_shape=(1, 1, 1))
    for backend in ("nccl", "gloo"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrain.main(["--multichip=2,1,1", "--dist-backend", backend,
                         "dataset.type=synthetic", f"out_dir={tmp_path}"])
    assert multihost.rank_device("cuda", 3).type == "cuda"
    assert multihost.rank_device("cpu", 3) == torch.device("cpu")
    rng = np.random.default_rng(0)
    fields = gaussians.padded_fields(
        rng.normal(size=(8, 3)).astype(np.float32),
        rng.normal(size=(8, 4)).astype(np.float32),
        np.full((8, 3), -2.0, np.float32), np.zeros((8, 1), np.float32),
        np.zeros((8, 3), np.float32), np.zeros((8, 45), np.float32), 16)
    params = gaussians.from_numpy(fields, device="cpu")
    for kw in (dict(packed_cull=True), dict(packed_l1=True)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.trace(params, np.zeros((256, 3), np.float32),
                      np.ones((256, 3), np.float32), **kw)
