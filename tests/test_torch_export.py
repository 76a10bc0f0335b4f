"""Export and import (threedgrut_torch/export/, api.load_scene) against the
JAX package's exporters on the same numpy inputs, and the port's own
MessagePack coder against the msgpack package. No card is needed: export
is host work.

Held exactly: PLY files byte for byte; .ingp and .nurec payloads after
gunzip (gzip headers carry the time); the .usda texts; imports of
JAX-written files field by field, padding and alive mask included; the
coder's bytes against msgpack.packb. ROADMAP C14 is shown on both sides."""
import gzip
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from threedgrut_torch import api as tapi
from threedgrut_torch.config import Config as TConfig
from threedgrut_torch.config import preset_3dgrt as tpreset_3dgrt
from threedgrut_torch.export import _msgpack
from threedgrut_torch.export import ingp as tingp
from threedgrut_torch.export import ply as tply
from threedgrut_torch.export import usdz as tusdz
from threedgrut_torch.model.gaussians import FIELDS, from_numpy
from threedgrut_tpu import api as japi
from threedgrut_tpu.config import Config as JConfig
from threedgrut_tpu.config import preset_3dgrt as jpreset_3dgrt
from threedgrut_tpu.export import ingp as jingp
from threedgrut_tpu.export import ply as jply
from threedgrut_tpu.export import usdz as jusdz
from threedgrut_tpu.model.gaussians import Gaussians as JGaussians

ROOT = Path(__file__).resolve().parent.parent


def fields(n=24, cap=32, deg=3, seed=0):
    """Raw fields of `n` particles in `cap` slots, with dead slots between
    the alive ones (as after a prune)."""
    rng = np.random.default_rng(seed)
    k = ((deg + 1) ** 2 - 1) * 3
    f = {"positions": rng.normal(size=(cap, 3)),
         "rotation": rng.normal(size=(cap, 4)),
         "scale": rng.normal(-2.0, 0.5, size=(cap, 3)),
         "density": rng.normal(size=(cap, 1)),
         "features_albedo": rng.normal(size=(cap, 3)),
         "features_specular": rng.normal(0, 0.2, size=(cap, k))}
    f = {key: v.astype(np.float32) for key, v in f.items()}
    alive = np.zeros(cap, bool)
    alive[rng.choice(cap, n, replace=False)] = True
    f["alive"] = alive
    return f


def both(f):
    return (JGaussians(**{k: jnp.asarray(v) for k, v in f.items()}),
            from_numpy(f, device="cpu"))


def np_of(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def assert_params_equal(t, j):
    for k in FIELDS:
        assert np.array_equal(np_of(getattr(t, k)), np_of(getattr(j, k))), k


def nurec_members(path):
    with zipfile.ZipFile(path) as z:
        names = z.namelist()
        infos = [i.compress_type for i in z.infolist()]
        data = {n: z.read(n) for n in names}
    return names, infos, data


# ---- the MessagePack coder ------------------------------------------------

EDGE_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 63, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63]
EDGE_FLOATS = [0.0, -0.0, 1.5, -2.25e-308, 5e-324, 1e308, float("inf"),
               float("-inf"), 0.0113, 0.0001]


def templates():
    jp, _ = both(fields())
    ingp_blob = {"nre_data": {"version": "0.0.1", "model": "mogt"},
                 "precision": "single", "mog_num": 24, "mog_sph_degree": 3,
                 "mog_positions": np.arange(72, dtype=np.float32).tobytes()}
    return [ingp_blob, jusdz.build_nurec_template(jp, 3, JConfig().render)]


@pytest.mark.parametrize("obj", [
    EDGE_INTS, EDGE_FLOATS, None, True, False, "", "a" * 31, "b" * 32,
    "c" * 255, "d" * 256, "e" * 65536, "ü→", b"", b"x" * 255, b"y" * 256,
    b"z" * 65536, list(range(15)), list(range(16)), list(range(65536)),
    {str(i): i for i in range(15)}, {str(i): [i] for i in range(16)},
    {str(i): None for i in range(65536)}, (1, (2.5, b"\x00")),
    *templates()], ids=lambda o: type(o).__name__)
def test_msgpack_matches_the_package(obj):
    data = _msgpack.packb(obj)
    assert data == msgpack.packb(obj)
    assert _msgpack.unpackb(data) == msgpack.unpackb(data, raw=False)


def test_msgpack_refuses_what_the_package_refuses():
    for bad, err in ((2 ** 64, OverflowError), (-2 ** 63 - 1, OverflowError),
                     (np.float32(1.0), TypeError), (object(), TypeError)):
        with pytest.raises(err):
            _msgpack.packb(bad)
        with pytest.raises(err):
            msgpack.packb(bad)
    good = _msgpack.packb({"a": [1, 2.0]})
    for data in (good[:-1], good + b"\x00", b"\xc1"):
        with pytest.raises(ValueError):
            _msgpack.unpackb(data)
    # float32, which msgpack.packb writes only with use_single_float=True.
    assert _msgpack.unpackb(msgpack.packb(0.5, use_single_float=True)) == 0.5


# ---- files the port writes, against JAX's ---------------------------------

def test_ply_bytes_match_jax(tmp_path):
    jp, tp = both(fields())
    jply.export_ply(jp, str(tmp_path / "j.ply"))
    tply.export_ply(tp, str(tmp_path / "t.ply"))
    data = (tmp_path / "t.ply").read_bytes()
    assert data == (tmp_path / "j.ply").read_bytes()
    assert b"element vertex 24\n" in data and b"f_rest_44" in data
    rows = tply.read_ply_fields(str(tmp_path / "t.ply"))
    alive = fields()["alive"]
    assert np.array_equal(rows["opacity"], fields()["density"][alive, 0])


@pytest.mark.parametrize("force_half", [False, True])
def test_ingp_payload_matches_jax(tmp_path, force_half):
    jp, tp = both(fields())
    jingp.export_ingp(jp, str(tmp_path / "j.ingp"), force_half=force_half)
    tingp.export_ingp(tp, str(tmp_path / "t.ingp"), force_half=force_half)
    payload = gzip.decompress((tmp_path / "t.ingp").read_bytes())
    assert payload == gzip.decompress((tmp_path / "j.ingp").read_bytes())
    blob = msgpack.unpackb(payload, raw=False)
    assert blob["mog_num"] == 24 and blob["mog_sph_degree"] == 3


@pytest.mark.parametrize("poses,render", [
    (None, "default"), ("poses", "default"), ("poses", "3dgrt")])
def test_usdz_matches_jax(tmp_path, poses, render):
    """The zip's member order and storage, the .usda texts and the .nurec
    payload; with dataset poses the normalizing transform too."""
    jp, tp = both(fields())
    rng = np.random.default_rng(3)
    ds = None
    if poses:
        ds = np.stack([np.eye(4)] * 6)
        ds[:, :3, :3] = np.linalg.qr(rng.normal(size=(6, 3, 3)))[0]
        ds[:, :3, 3] = rng.normal(size=(6, 3)) + 4.0
        np.testing.assert_array_equal(
            tusdz.estimate_normalizing_transform(list(ds)),
            jusdz.estimate_normalizing_transform(ds))
    jcfg, tcfg = ((JConfig().render, TConfig().render) if render == "default"
                  else (jpreset_3dgrt().render, tpreset_3dgrt().render))
    jusdz.export_usdz(jp, str(tmp_path / "scene.usdz"), render_cfg=jcfg,
                      dataset_poses=ds)
    os.makedirs(tmp_path / "t")
    tusdz.export_usdz(tp, str(tmp_path / "t" / "scene.usdz"),
                      render_cfg=tcfg, dataset_poses=ds)
    jn, ji, jd = nurec_members(tmp_path / "scene.usdz")
    tn, ti, td = nurec_members(tmp_path / "t" / "scene.usdz")
    assert tn == jn == ["scene.usda", "scene_gauss.usda", "scene.nurec"]
    assert ti == ji == [zipfile.ZIP_STORED] * 3
    for name in jn[:2]:
        assert td[name].decode() == jd[name].decode(), name
    payload = gzip.decompress(td["scene.nurec"])
    assert payload == gzip.decompress(jd["scene.nurec"])
    sd = _msgpack.unpackb(payload)["nre_data"]["state_dict"]
    pos = np.frombuffer(sd[".gaussians_nodes.gaussians.positions"],
                        np.float16).reshape(24, 3)
    alive = fields()["alive"]
    assert np.array_equal(pos, fields()["positions"][alive]
                          .astype(np.float16))
    if ds is not None:
        assert "( (-1, 0, 0, 0)" not in td["scene_gauss.usda"].decode()


# ---- files JAX writes, read by the port ----------------------------------

@pytest.mark.parametrize("fmt", ["ply", "ingp", "ingp_half"])
@pytest.mark.parametrize("capacity", [None, 40])
def test_imports_of_jax_files_match_jax(tmp_path, fmt, capacity):
    jp, _ = both(fields())
    path = str(tmp_path / ("s.ply" if fmt == "ply" else "s.ingp"))
    if fmt == "ply":
        jply.export_ply(jp, path)
        want = jply.import_ply(path, capacity=capacity)
        got = tply.import_ply(path, capacity=capacity, device="cpu")
    else:
        jingp.export_ingp(jp, path, force_half=fmt == "ingp_half")
        want = jingp.import_ingp(path, capacity=capacity)
        got = tingp.import_ingp(path, capacity=capacity, device="cpu")
    assert_params_equal(got, want)
    assert got.capacity == (capacity or 4096) and int(got.num_active()) == 24


@pytest.mark.parametrize("ext", [".ply", ".ingp"])
def test_load_scene_matches_jax(tmp_path, ext):
    """api.load_scene on a JAX-written file equals JAX's, capacity passed
    through; on the port's own file it gives back the alive rows bit for
    bit."""
    f = fields()
    jp, tp = both(f)
    path = str(tmp_path / f"s{ext}")
    (jply.export_ply if ext == ".ply" else jingp.export_ingp)(jp, path)
    assert_params_equal(tapi.load_scene(path, capacity=64, device="cpu"),
                        japi.load_scene(path, capacity=64))
    own = str(tmp_path / f"own{ext}")
    (tply.export_ply if ext == ".ply" else tingp.export_ingp)(tp, own)
    back = tapi.load_scene(own, device="cpu")
    for k in FIELDS[:-1]:
        assert np.array_equal(np_of(getattr(back, k))[:24],
                              f[k][f["alive"]]), k
    assert back.alive.tolist() == [True] * 24 + [False] * (4096 - 24)


def test_ply_to_usd_module(tmp_path):
    """python -m threedgrut_torch.export.ply_to_usd writes the usdz that
    scripts/ply_to_usd.py writes, without a card."""
    from scripts.ply_to_usd import main as jply_to_usd
    jp, _ = both(fields())
    ply_path = tmp_path / "m.ply"
    jply.export_ply(jp, str(ply_path))
    out = tmp_path / "out" / "m.usdz"
    out.parent.mkdir()
    r = subprocess.run(
        [sys.executable, "-m", "threedgrut_torch.export.ply_to_usd",
         str(ply_path), "--output_file", str(out)], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"wrote {out}"
    assert jply_to_usd([str(ply_path)]) == 0
    tn, _, td = nurec_members(out)
    jn, _, jd = nurec_members(tmp_path / "m.usdz")
    assert tn == jn
    assert td["m_gauss.usda"] == jd["m_gauss.usda"]
    assert gzip.decompress(td["m.nurec"]) == gzip.decompress(jd["m.nurec"])


def test_ingp_max_sh_degree_c14(tmp_path):
    """ROADMAP C14: JAX's export_ingp(max_sh_degree=1) on a degree-3 scene
    declares degree 1 but writes all 48 feature columns, and its own import
    fails. The port writes the first 4 coefficients, which both importers
    read back; a degree above the scene's is refused."""
    jp, tp = both(fields())
    jpath, tpath = str(tmp_path / "j.ingp"), str(tmp_path / "t.ingp")
    jingp.export_ingp(jp, jpath, max_sh_degree=1)
    with pytest.raises(ValueError, match="reshape"):
        jingp.import_ingp(jpath)
    tingp.export_ingp(tp, tpath, max_sh_degree=1)
    back = tingp.import_ingp(tpath, device="cpu")
    assert back.max_sh_degree == 1
    alive = fields()["alive"]
    assert np.array_equal(np_of(back.features_specular)[:24],
                          fields()["features_specular"][alive, :9])
    assert_params_equal(back, jingp.import_ingp(tpath))
    with pytest.raises(ValueError, match="exceeds"):
        tingp.export_ingp(tp, tpath, max_sh_degree=4)
