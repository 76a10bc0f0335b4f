"""The port's playground around the engine against the JAX package's: the
scene graph's edits, the .glb loader, video trajectories, the web
viewer's HTTP surface in every mode and channel, the playground entry
(`python -m threedgrut_torch.playground`), the live training viewer
(threedgrut_torch/gui.py) with the trainer's snapshot lock and the train
entry's --with-gui; and three faults of the JAX playground that the port
does not copy (ROADMAP C4, C15, C16), each shown on both sides. Where a
JAX side needs only its control flow, its renderers are replaced by stubs
(a JAX engine call costs ~20 s in interpret mode); the port side renders
for real, on the CPU, at 16x16 to 32x32.

Tolerances: the scene graph's and the loader's arrays exactly equal (the
same numpy arithmetic); trajectories exactly equal; frames finite, of
the resolution's shape, a raster frame's refresh within 2e-6 of the exact
frame (tests/test_torch_infer.py's bound)."""
import io
import json
import os
import struct
import threading
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_gut_reference import random_scene
from tests.test_torch_grt import single_thread  # noqa: F401 (autouse)
from threedgrut_torch import gui as tgui
from threedgrut_torch import train as ttrain
from threedgrut_torch.cameras import pose_from_matrix
from threedgrut_torch.config import Config
from threedgrut_torch.datasets.dataset_synthetic import SyntheticDataset
from threedgrut_torch.model import gaussians as tg
from threedgrut_torch.playground import __main__ as tcli
from threedgrut_torch.playground import engine as teng
from threedgrut_torch.playground import gltf as tgltf
from threedgrut_torch.playground import materials as tmat
from threedgrut_torch.playground import mesh as tmesh
from threedgrut_torch.playground import scene as tscene
from threedgrut_torch.playground import video as tvideo
from threedgrut_torch.playground import web_viewer as tweb
from threedgrut_torch.render import gut as tgut
from threedgrut_torch.trainer import Trainer
from threedgrut_tpu import gui as jgui
from threedgrut_tpu.playground import engine as jeng
from threedgrut_tpu.playground import gltf as jgltf
from threedgrut_tpu.playground import materials as jmat
from threedgrut_tpu.playground import mesh as jmesh
from threedgrut_tpu.playground import scene as jscene
from threedgrut_tpu.playground import video as jvideo
from threedgrut_tpu.playground import web_viewer as jweb

RES = (16, 16)


def npy(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def scene_tensors(n=24, seed=9, z=0.0):
    return tuple(torch.tensor(np.asarray(x))
                 for x in random_scene(n=n, seed=seed, z=z))


def port_engine(mesh=None, materials=None, **cfg):
    cfg = dict(dict(max_bounces=1, candidate_capacity=64), **cfg)
    return teng.Engine(*scene_tensors(), mesh=mesh, materials=materials,
                       config=teng.EngineConfig(**cfg), device="cpu")


def assert_same_mesh(got, want):
    for f in tmesh.FIELDS:
        np.testing.assert_array_equal(npy(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


# ---- scene graph ------------------------------------------------------------

def test_scene_graph_edits_match_jax():
    """tests/test_playground.py's edits on both scene graphs: stacked
    meshes, material tables and describe() equal after each."""
    specs = [dict(kind=jmat.MaterialKind.MIRROR),
             dict(kind=jmat.MaterialKind.GLASS, ior=1.33)]
    jsg = jscene.SceneGraph(material_specs=[dict(s) for s in specs])
    tsg = tscene.SceneGraph(material_specs=[dict(s) for s in specs],
                            device="cpu")
    jq = jmesh.make_quad([0, 0, 0], [1, 0, 0], [0, 1, 0])
    tq = tmesh.make_quad([0, 0, 0], [1, 0, 0], [0, 1, 0], device="cpu")
    js = jmesh.make_icosphere([0.5, 0, 0], 0.3, 1)
    ts = tmesh.make_icosphere([0.5, 0, 0], 0.3, 1, device="cpu")

    def both(fn_name, *args, **kw):
        getattr(jsg, fn_name)(*args, **kw)
        getattr(tsg, fn_name)(*args, **kw)
        assert tsg.describe() == jsg.describe()
        if jsg.mesh() is None:
            assert tsg.mesh() is None
        else:
            assert_same_mesh(tsg.mesh(), jsg.mesh())
        for f in tmat.FIELDS:
            np.testing.assert_array_equal(
                npy(getattr(tsg.materials(), f)),
                np.asarray(getattr(jsg.materials(), f)), f)

    jsg.add("floor", jq, translation=(0, 0, -1))
    tsg.add("floor", tq, translation=(0, 0, -1))
    jsg.add("floor", jq)
    tsg.add("floor", tq)
    assert set(tsg.primitives) == {"floor", "floor_2"}
    jsg.add("ball", js, rotation_euler=(0.1, 0.2, 0.3), scale=1.5)
    tsg.add("ball", ts, rotation_euler=(0.1, 0.2, 0.3), scale=1.5)
    both("update", "floor_2", visible=False)
    both("update", "floor", rotation_euler=(0, 0, np.pi / 2), scale=2.0,
         material_id=1)
    both("duplicate", "floor")
    both("remove", "floor")
    both("set_material", 0, base_color=(1.0, 0.0, 0.0), roughness=0.25)
    both("add_material", dict(kind=jmat.MaterialKind.PBR, metallic=0.5))
    both("update", "ball", visible=False)
    both("update", "floor_3", visible=False)
    assert tsg.mesh() is None
    with pytest.raises(KeyError):
        tsg.update("ball", nope=1)
    with pytest.raises(KeyError):
        tsg.set_material(0, nope=1)


# ---- glTF -------------------------------------------------------------------

def png_bytes(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def write_glb(path, texture=None, normal_texture=None):
    """A GLB as test_playground.py's test_glb_roundtrip writes one, with a
    rotated, scaled and translated node, vertex normals interleaved with
    the positions (a strided view) and, optionally, embedded PNG base
    colour and normal textures."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    inter = np.concatenate([pos, nrm], 1).tobytes()
    blobs = [inter, uv.tobytes(), idx.tobytes()]
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": 96,
              "byteStride": 24},
             {"buffer": 0, "byteOffset": 96, "byteLength": 32},
             {"buffer": 0, "byteOffset": 128, "byteLength": 24}]
    images, textures = [], []
    off = 152
    for img in (texture, normal_texture):
        if img is None:
            continue
        data = img if isinstance(img, bytes) else png_bytes(img)
        data += b"\0" * ((4 - len(data) % 4) % 4)
        views.append({"buffer": 0, "byteOffset": off,
                      "byteLength": len(data)})
        images.append({"bufferView": len(views) - 1,
                       "mimeType": "image/png"})
        textures.append({"source": len(images) - 1})
        blobs.append(data)
        off += len(data)
    binb = b"".join(blobs)
    material = {"pbrMetallicRoughness": {
        "baseColorFactor": [0.9, 0.2, 0.1, 1.0], "metallicFactor": 0.3,
        "roughnessFactor": 0.7}, "emissiveFactor": [0.1, 0.0, 0.2]}
    if texture is not None:
        material["pbrMetallicRoughness"]["baseColorTexture"] = {"index": 0}
    if normal_texture is not None:
        material["normalTexture"] = {"index": len(textures) - 1}
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [1.0, 0.0, 0.5],
                   "rotation": [0.0, 0.0, 0.3826834, 0.9238795],
                   "scale": [2.0, 2.0, 2.0]}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
            "indices": 3, "material": 0}]}],
        "materials": [material],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126,
             "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4,
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5125, "count": 6,
             "type": "SCALAR"}],
        "bufferViews": views, "buffers": [{"byteLength": len(binb)}],
        "images": images, "textures": textures}
    js = json.dumps(gltf).encode()
    js += b" " * ((4 - len(js) % 4) % 4)
    total = 12 + 8 + len(js) + 8 + len(binb)
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, total)
                     + struct.pack("<II", len(js), 0x4E4F534A) + js
                     + struct.pack("<II", len(binb), 0x004E4942) + binb)
    return str(path)


def textures():
    rng = np.random.default_rng(5)
    return (rng.integers(0, 256, (4, 6, 3), dtype=np.uint8),
            rng.integers(0, 256, (3, 3, 3), dtype=np.uint8))


def test_glb_loader_matches_jax(tmp_path):
    """A textured, normal-mapped .glb: mesh, material specs and tables
    equal to the JAX loader's."""
    tex, ntex = textures()
    path = write_glb(tmp_path / "a.glb", tex, ntex)
    jm, jspecs = jgltf.load_glb_scene(path)
    tm, tspecs = tgltf.load_glb_scene(path, device="cpu")
    assert_same_mesh(tm, jm)
    assert tm.num_faces == 2
    np.testing.assert_allclose(npy(tm.vertices)[0], [1.0, 0.0, 0.5])
    assert len(tspecs) == len(jspecs) == 1
    for k, v in jspecs[0].items():
        np.testing.assert_array_equal(np.asarray(tspecs[0][k]),
                                      np.asarray(v), k)
    np.testing.assert_array_equal(tspecs[0]["base_color_texture"],
                                  tex.astype(np.float32) / 255.0)
    _, jmats = jgltf.load_glb(path)
    _, tmats = tgltf.load_glb(path, device="cpu")
    for f in tmat.FIELDS:
        np.testing.assert_array_equal(npy(getattr(tmats, f)),
                                      np.asarray(getattr(jmats, f)), f)


def test_glb_bad_texture_raises_where_jax_drops_it(tmp_path):
    """A texture that does not decode: the JAX loader catches every
    exception and keeps the factor-only material; the port lets PIL's
    error rise."""
    path = write_glb(tmp_path / "bad.glb", texture=b"not a png!")
    _, jspecs = jgltf.load_glb_scene(path)
    assert "base_color_texture" not in jspecs[0]
    with pytest.raises(OSError):
        tgltf.load_glb_scene(path, device="cpu")


# ---- video ------------------------------------------------------------------

def test_trajectories_match_jax():
    pts = np.random.default_rng(2).normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvideo.catmull_rom(pts, 13),
                                  jvideo.catmull_rom(pts, 13))
    for a, b in zip(tvideo.orbit_trajectory(5, 3.0, 1.0, (0.1, 0, 0)),
                    jvideo.orbit_trajectory(5, 3.0, 1.0, (0.1, 0, 0))):
        np.testing.assert_array_equal(a, b)
    kf = tvideo.orbit_trajectory(3, radius=3.0)
    for a, b in zip(tvideo.keyframe_trajectory(kf, 7),
                    jvideo.keyframe_trajectory(kf, 7)):
        np.testing.assert_array_equal(a, b)


def test_render_video_png_sequence_and_encoder_errors(tmp_path,
                                                      monkeypatch):
    """Without an MP4 backend the port writes a PNG sequence and says so
    in the returned path; an encoder error rises where the JAX function
    swallows it and writes PNGs."""
    e = port_engine()
    cam = tweb.WebViewer(e, resolution=RES)._camera()
    traj = tvideo.orbit_trajectory(2, radius=3.0)
    monkeypatch.setattr(tvideo, "mp4_writer", lambda: None)
    out = tvideo.render_video(e, cam, traj, RES, str(tmp_path / "o.mp4"))
    assert out == str(tmp_path / "o")
    frames = sorted(os.listdir(out))
    assert frames == ["frame_0000.png", "frame_0001.png"]
    assert np.asarray(Image.open(os.path.join(out, frames[0]))).shape == (
        16, 16, 3)

    def broken_writer():
        def mimwrite(*a, **k):
            raise OSError("encoder failed")
        return types.SimpleNamespace(mimwrite=mimwrite)

    monkeypatch.setattr(tvideo, "mp4_writer", broken_writer)
    with pytest.raises(OSError, match="encoder failed"):
        tvideo.render_video(e, cam, traj, RES, str(tmp_path / "p.mp4"))
    # The JAX function, given the same failing encoder, returns PNGs.
    import imageio.v2 as imageio
    monkeypatch.setattr(imageio, "mimwrite", broken_writer().mimwrite)
    stub = types.SimpleNamespace(
        render=lambda cam, T, res: {"rgb": jnp.zeros((16, 16, 3))})
    got = jvideo.render_video(stub, None, traj, RES, str(tmp_path / "q.mp4"))
    assert got == str(tmp_path / "q")


# ---- the web viewer ---------------------------------------------------------

def serve(viewer):
    server = viewer.serve(port=0, blocking=False, host="127.0.0.1")
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def get(url, timeout=120):
    return urllib.request.urlopen(url, timeout=timeout).read()


def post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=120).read())


def jpeg(data):
    assert data[:2] == b"\xff\xd8"
    return np.asarray(Image.open(io.BytesIO(data)))


def test_http_surface_every_mode_and_channel(tmp_path):
    """GET /, /render in trace, hybrid and raster mode and each channel,
    /state, /info, /train_status (404 without a trainer); POST /config,
    /preset, /material, /primitive (update, duplicate, remove), /traj
    (add, save, clear, load, render: a 2-keyframe video), and a 400 for an
    edit the viewer cannot apply."""
    sg = tscene.SceneGraph(material_specs=[
        dict(kind=tmat.MaterialKind.MIRROR),
        dict(kind=tmat.MaterialKind.GLASS, ior=1.33)], device="cpu")
    sg.add("ball", tmesh.make_icosphere([0, 0, 0], 0.4, device="cpu"),
           material_id=1)
    e = port_engine()
    viewer = tweb.WebViewer(e, resolution=RES, scene=sg,
                            traj_path=str(tmp_path / "traj.json"),
                            video_path=str(tmp_path / "traj.mp4"))
    assert e.mesh.num_faces == 80
    server, url = serve(viewer)
    try:
        assert b"threedgrut_torch playground" in get(url + "/")
        for mode in ("trace", "hybrid", "raster"):
            for channel in ("color", "density", "depth"):
                st = post(url + "/config", {"mode": mode,
                                            "channel": channel})
                assert st["mode"] == mode and st["channel"] == channel
                img = jpeg(get(url + "/render?yaw=0.5&pitch=0.3"
                               "&radius=3"))
                assert img.shape == (16, 16, 3), (mode, channel)
        assert json.loads(get(url + "/info")) == json.loads(
            get(url + "/state"))
        with pytest.raises(urllib.error.HTTPError) as err:
            get(url + "/train_status")
        assert err.value.code == 404
        st = post(url + "/config", {"gamma": 2.2, "mode": "trace"})
        assert st["config"]["gamma"] == 2.2
        st = post(url + "/preset", {"name": "fast"})
        assert st["config"]["spp"] == 1 and st["config"]["max_bounces"] == 2
        st = post(url + "/material", {"id": 0, "roughness": 0.7})
        assert st["scene"]["materials"][0]["roughness"] == 0.7
        assert float(e.materials.roughness[0]) == pytest.approx(0.7)
        st = post(url + "/primitive", {"name": "ball",
                                       "translation": [1, 0, 0]})
        assert st["scene"]["primitives"]["ball"]["translation"][0] == 1.0
        assert float(e.mesh.vertices[:, 0].mean()) > 0.5
        st = post(url + "/primitive", {"name": "ball", "op": "duplicate"})
        assert set(st["scene"]["primitives"]) == {"ball", "ball_2"}
        assert e.mesh.num_faces == 160
        st = post(url + "/primitive", {"name": "ball_2", "op": "remove"})
        assert e.mesh.num_faces == 80
        for cam in ((0.1, 0.2, 3.0), (0.4, 0.2, 3.5)):
            st = post(url + "/traj", dict(zip(("yaw", "pitch", "radius"),
                                               cam), op="add"))
        assert len(st["trajectory"]) == 2
        post(url + "/traj", {"op": "save"})
        assert len(post(url + "/traj", {"op": "clear"})["trajectory"]) == 0
        st = post(url + "/traj", {"op": "load"})
        assert len(st["trajectory"]) == 2
        post(url + "/traj", {"op": "render", "frames": 2})
        for _ in range(600):
            status = json.loads(get(url + "/state"))["video_status"]
            if not status.startswith("rendering"):
                break
            threading.Event().wait(0.1)
        if tvideo.mp4_writer() is None:
            assert status == f"wrote {tmp_path / 'traj'}", status
            assert len(os.listdir(tmp_path / "traj")) == 2
        else:
            assert status == f"wrote {tmp_path / 'traj.mp4'}", status
        for path, body in (("/config", {"nope": 1}),
                           ("/preset", {"name": "nope"}),
                           ("/material", {"id": 7, "roughness": 0.1}),
                           ("/primitive", {"name": "nope", "scale": 2})):
            with pytest.raises(urllib.error.HTTPError) as err:
                post(url + path, body)
            assert err.value.code == 400, path
        with pytest.raises(urllib.error.HTTPError) as err:
            post(url + "/nope", {})
        assert err.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


# ---- C4: the raster mode's refresh test -------------------------------------

def stub_raster_jits(monkeypatch, overflow):
    """JAX's raster-mode programs replaced by stubs that return a blank
    frame and the given overflow flags; returns the call log."""
    calls = []
    blank = types.SimpleNamespace(rgb=jnp.zeros((32, 32, 3)),
                                  opacity=jnp.zeros((32, 32)),
                                  depth=jnp.zeros((32, 32)))

    def refresh(P, cam, T, res, cap, n_c):
        calls.append(("refresh", cap, n_c))
        return blank, overflow, types.SimpleNamespace(overflow=False)

    def compact(scene, cam, T, res, cap_c, aux):
        calls.append(("compact", cap_c))
        return blank, overflow

    monkeypatch.setattr(jweb, "_RASTER_JITS", (refresh, compact))
    return calls


def jax_raster_viewer():
    g = random_scene(n=24, seed=9, z=0.0)
    v = jweb.WebViewer(jeng.Engine(*g), resolution=(32, 32))
    v.mode = "raster"
    return v


YAWS = (0.50, 0.55, 0.60, 0.65)   # steps of 0.05; 0.15 from the first


def test_c4_refresh_tracks_drift_since_the_last_refresh(monkeypatch):
    """Four frames 0.05 rad apart: JAX's viewer compares each with the
    frame before it (its key moves on every compacted frame), so it never
    refreshes; the port compares with the last refresh and refreshes once
    the drift passes 0.12. The port's refresh frame is the exact frame
    within 2e-6."""
    calls = stub_raster_jits(monkeypatch, overflow=False)
    jv = jax_raster_viewer()
    for yaw in YAWS:
        jv.render_frame(yaw, 0.3, 3.0)
    assert [c[0] for c in calls] == ["refresh"] + ["compact"] * 3
    assert jv._raster_cache["frames"] == 3

    tv = tweb.WebViewer(port_engine(), resolution=(32, 32))
    tv.mode = "raster"
    kinds = []
    for yaw in YAWS:
        tv.render_outputs(yaw, 0.3, 3.0)
        kinds.append("refresh" if tv._raster_cache["frames"] == 0
                     else "compact")
        assert tv._raster_cache["key"][0] == (YAWS[0] if len(kinds) < 4
                                              else YAWS[3])
    assert kinds == ["refresh", "compact", "compact", "refresh"]
    out = tv.render_outputs(0.65, 0.3, 3.0)          # compacted frame
    T = tv._pose(0.65, 0.3, 3.0)
    exact, _ = tgut.render(*tv.engine.gaussians, tv._camera(),
                           pose_from_matrix(T), (32, 32),
                           tv._raster_caps[0], T_to_world=T, device="cpu")
    np.testing.assert_allclose(npy(out["rgb"]), npy(exact.rgb), atol=2e-6)


# ---- C15: the engine's overflow flag ----------------------------------------

def test_c15_engine_reports_the_trace_overflow(monkeypatch):
    """With a candidate capacity below the scene's candidates, the JAX
    engine drops the trace's overflow flag: render returns no flag, and
    render_hybrid only the rasterizer's (its traces stubbed to overflow,
    its rasterizer not to). The port's frames carry the OR of every trace
    pass's flag and the rasterizer's, and its super lists grow with the
    candidate capacity."""
    g = random_scene(n=8, seed=1)
    jm = jmesh.make_quad([0.0, 0.0, 5.0], [3.0, 0, 0], [0, 3.0, 0])
    mats = jmat.make_materials([dict(kind=jmat.MaterialKind.MIRROR)])

    def trace(pos, q, s, o, f, ro, rd, **kw):
        r = ro.shape[0]
        return types.SimpleNamespace(
            rgb=jnp.zeros((r, 3)), opacity=jnp.zeros(r),
            depth=jnp.zeros(r), transmittance=jnp.ones(r),
            overflow=jnp.asarray(True))

    def raster(*a, **kw):
        out = types.SimpleNamespace(
            rgb=jnp.zeros((16, 16, 3)), opacity=jnp.zeros((16, 16)),
            depth=jnp.zeros((16, 16)), transmittance=jnp.ones((16, 16)))
        return out, jnp.asarray(False)

    monkeypatch.setattr(jeng.grt, "trace", trace)
    monkeypatch.setattr(jeng.gut, "render", raster)
    from tests.test_cameras import make_pinhole
    je = jeng.Engine(*g, mesh=jm, materials=mats,
                     config=jeng.EngineConfig(max_bounces=2))
    cam = make_pinhole(f=30.0, cx=8.0, cy=8.0)
    assert "overflow" not in je._render_eager(cam, jnp.eye(4), RES)
    assert not bool(je.render_hybrid(cam, jnp.eye(4), RES)["overflow"])

    tm = tmesh.make_quad([0.0, 0.0, 5.0], [3.0, 0, 0], [0, 3.0, 0],
                         device="cpu")
    te = teng.Engine(*(torch.tensor(np.asarray(x))
                       for x in random_scene(n=48, seed=4)), mesh=tm,
                     materials=tmat.make_materials(
                         [dict(kind=tmat.MaterialKind.MIRROR)], "cpu"),
                     config=teng.EngineConfig(max_bounces=2,
                                              candidate_capacity=8),
                     device="cpu")
    tcam = tweb.WebViewer(te, resolution=RES, fov_deg=60.0)._camera()
    T = torch.tensor([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, -1.0],
                      [0, 0, 0, 1]])
    hyb = te.render_hybrid(tcam, T, RES)
    assert bool(hyb["overflow"])             # the traced reflections'
    _, raster_ovf = tgut.render(*te.gaussians, tcam, pose_from_matrix(T),
                                RES, 8 * 256, T_to_world=T, device="cpu")
    assert not bool(raster_ovf)              # the rasterizer's is clear
    assert bool(te.render(tcam, T, RES)["overflow"])
    te.cfg.candidate_capacity = 64
    assert not bool(te.render_hybrid(tcam, T, RES)["overflow"])
    assert teng.super_lists(4096) == dict(super_capacity=65536,
                                          two_level_above=8192)
    assert teng.super_lists(64)["super_capacity"] == 8192
    seen = []
    real = teng.grt.trace
    monkeypatch.setattr(teng.grt, "trace", lambda *a, **kw: (
        seen.append((kw["candidate_capacity"], kw["super_capacity"])),
        real(*a, **kw))[1])
    te.cfg.candidate_capacity = 2048
    te.render(tcam, T, RES)
    assert seen == [(2048, 32768)] * 2


# ---- C16: truncated frames --------------------------------------------------

def test_c16_raster_mode_grows_or_raises(monkeypatch):
    """JAX's raster mode gives up after four overflowing attempts and
    returns the last, truncated, frame. The port's grows each capacity
    until the frame fits (and then equals a frame rendered at a capacity
    that fits), and raises at the ceiling."""
    calls = stub_raster_jits(monkeypatch, overflow=True)
    frame = jax_raster_viewer().render_frame(0.5, 0.3, 3.0)
    assert len(calls) == 4 and frame.shape == (32, 32, 3)

    e = teng.Engine(*scene_tensors(n=400), device="cpu")
    tv = tweb.WebViewer(e, resolution=(32, 32))
    tv.mode = "raster"
    tv._raster_caps = [256, 4, 256]
    out = tv.render_outputs(0.5, 0.3, 3.0)
    whats = {w for _, w, _ in tv.grown}
    assert whats == {"isect_capacity", "n_compact"}, tv.grown
    T = tv._pose(0.5, 0.3, 3.0)
    exact, ovf = tgut.render(*tv.engine.gaussians, tv._camera(),
                             pose_from_matrix(T), (32, 32), 1 << 16,
                             T_to_world=T, device="cpu")
    assert not bool(ovf)
    np.testing.assert_allclose(npy(out["rgb"]), npy(exact.rgb), atol=2e-6)
    tv._raster_caps, tv._raster_cache = [256, 400, 256], None
    monkeypatch.setattr(tweb, "MAX_ISECT_CAPACITY", 256)
    with pytest.raises(RuntimeError, match="ceiling"):
        tv.render_outputs(0.5, 0.3, 3.0)
    e = port_engine(candidate_capacity=4)
    monkeypatch.setattr(teng, "MAX_CANDIDATE_CAPACITY", 8)
    with pytest.raises(RuntimeError, match="ceiling"):
        tweb.WebViewer(e, resolution=RES).render_outputs(0.5, 0.3, 3.0)
    assert e.cfg.candidate_capacity == 8


def synthetic_trainer(isect_capacity=1 << 11, n=16):
    """A trainer on the synthetic scene from n points (its ground truth's
    16, or random ones about the origin)."""
    ds = SyntheticDataset(num_views=2, resolution=RES, num_gt_gaussians=16,
                          seed=3, device="cpu")
    cfg = Config()
    cfg.render.isect_capacity = isect_capacity
    pts = (np.asarray(ds.scene[0]) if n == 16 else np.random.default_rng(
        7).normal(0, 0.4, (n, 3)).astype(np.float32))
    params = tg.init_from_points(pts, capacity=-(-n // 32) * 32,
                                 device="cpu")
    return Trainer(cfg, ds, params=params, device="cpu")


def test_c16_live_viewer_renders_at_the_trainers_capacity(monkeypatch):
    """JAX's live viewer renders with the config's isect_capacity (not the
    trainer's grown one) and drops the overflow flag; the port's renders
    with the trainer's current capacity and grows on overflow."""
    seen = []

    def record(*args, **kw):
        seen.append(args[8])
        out = types.SimpleNamespace(rgb=jnp.zeros((16, 16, 3)),
                                    opacity=jnp.zeros((16, 16)),
                                    depth=jnp.zeros((16, 16)))
        return out, jnp.asarray(True)

    from threedgrut_tpu.render import gut as jgut
    monkeypatch.setattr(jgut, "render", record)
    params = types.SimpleNamespace(**{
        k: (lambda x=x: jnp.asarray(x)) for k, x in zip(
            ("get_positions", "get_rotation", "get_scale", "get_density",
             "get_features"), random_scene(n=8, seed=1))})
    jtrainer = types.SimpleNamespace(
        params=params, isect_capacity=8192, active_sh_degree=lambda: 3,
        cfg=types.SimpleNamespace(
            render=types.SimpleNamespace(isect_capacity=2048)))
    out = jgui._TrainerEngineProxy(jtrainer).render(
        None, jnp.eye(4), RES)
    assert seen == [2048] and "overflow" not in out

    tr = synthetic_trainer(n=600)
    tr.isect_capacity = 4096
    proxy = tgui.TrainerEngineProxy(tr)
    viewer = tweb.WebViewer(proxy, resolution=RES)
    viewer.render_frame(0.4, 0.3, 4.0)
    assert proxy.isect_capacity == 4096
    tr.isect_capacity = proxy.isect_capacity = 256
    grown = []
    out = proxy.render_fitted(viewer._camera(), viewer._pose(0.4, 0.3, 4.0),
                              RES, grown=grown)
    assert grown and not bool(out["overflow"])
    assert proxy.isect_capacity == grown[-1] > 256


# ---- the live training viewer -----------------------------------------------

def test_training_gui_serves_a_consistent_live_scene():
    """TrainingGUI on a live trainer: frames requested from another thread
    while 3 steps run are finite, /train_status reports the steps, and a
    snapshot waits while a step holds the trainer's lock."""
    tr = synthetic_trainer()
    gui = tgui.TrainingGUI(tr, port=0, resolution=RES, host="127.0.0.1")
    url = f"http://127.0.0.1:{gui.server.server_address[1]}"
    frames, errors, stop = [], [], threading.Event()

    def requester():
        while not stop.is_set():
            try:
                frames.append(jpeg(get(url + "/render?yaw=0.4&pitch=0.3"
                                       "&radius=4")))
            except Exception as e:        # surfaced by the assert below
                errors.append(e)
                return

    worker = threading.Thread(target=requester, daemon=True)
    try:
        worker.start()
        tr.run(iterations=3, log_every=1)
        stop.set()
        worker.join(timeout=60)
        assert not worker.is_alive() and not errors, errors
        assert frames and all(np.isfinite(f).all() for f in frames)
        st = json.loads(get(url + "/train_status"))
        assert st["step"] == 3 and len(st["history"]) == 3
        assert json.loads(get(url + "/state"))["has_training"] is True

        taken = threading.Event()
        with tr.lock:
            t = threading.Thread(
                target=lambda: (gui.proxy.snapshot(), taken.set()),
                daemon=True)
            t.start()
            assert not taken.wait(0.3)     # blocked by the held lock
        assert taken.wait(30)
        snap = gui.proxy.snapshot()
        live = tr.params.get_positions()
        assert snap[0].data_ptr() != live.data_ptr()
        np.testing.assert_array_equal(npy(snap[0]), npy(live))
    finally:
        stop.set()
        gui.close()


def test_train_entry_with_gui(tmp_path, monkeypatch):
    """`python -m threedgrut_torch.train --with-gui` serves the training
    scene while the run trains (read just before the viewer closes)."""
    seen = {}
    close = tgui.TrainingGUI.close

    def read_then_close(self):
        url = f"http://127.0.0.1:{self.server.server_address[1]}"
        seen["status"] = json.loads(get(url + "/train_status"))
        seen["frame"] = jpeg(get(url + "/render?yaw=0.4&pitch=0.3"
                                 "&radius=4"))
        close(self)

    monkeypatch.setattr(tgui.TrainingGUI, "close", read_then_close)
    ttrain.run([
        "--device", "cpu", "--with-gui", "--gui-port", "0",
        "--config-name", "nerf_synthetic_3dgut", "dataset.type=synthetic",
        "dataset.synthetic_views=2", "dataset.synthetic_resolution=16",
        "dataset.synthetic_gt=16", "train.iterations=2",
        "train.val_frequency=0", "render.isect_capacity=4096",
        "model.capacity=1024", "strategy.method=none",
        f"out_dir={tmp_path}", "experiment_name=g"])
    assert seen["status"]["step"] == 2
    assert seen["frame"].shape == (400, 400, 3)


# ---- the playground entry ---------------------------------------------------

def test_playground_entry(tmp_path, capsys):
    """`python -m threedgrut_torch.playground --no-serve --device cpu` on a
    .ply scene with an .obj and a .glb asset and an envmap."""
    from threedgrut_torch.export.ply import export_ply
    rng = np.random.default_rng(0)
    n = 32
    params = tg.from_arrays(
        rng.normal(0, 0.4, (n, 3)).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        np.full((n, 3), np.log(0.1), np.float32),
        np.full((n, 1), 1.0, np.float32),
        rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        np.zeros((n, 45), np.float32), capacity=32, device="cpu")
    ply = str(tmp_path / "scene.ply")
    export_ply(params, ply)
    assets = tmp_path / "assets"
    assets.mkdir()
    q = tmesh.make_quad([0, 0, -1.5], [2, 0, 0], [0, 2, 0], device="cpu")
    v, f = npy(q.vertices), npy(q.faces)
    (assets / "floor.obj").write_text(
        "".join(f"v {a} {b} {c}\n" for a, b, c in v)
        + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f))
    write_glb(assets / "card.glb", *textures())
    env = str(tmp_path / "env.png")
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (8, 16, 3), dtype=np.uint8)).save(env)
    argv = ["--gs_object", ply, "--mesh_assets", str(assets), "--envmap",
            env, "--resolution", "16", "16", "--max_bounces", "2",
            "--no-serve", "--device", "cpu"]
    assert tcli.main(argv) == 0
    assert "rendered (16, 16, 3)" in capsys.readouterr().out
    viewer, sg = tcli.build(tcli.parse_args(argv))
    assert set(sg.primitives) == {"floor", "card"}
    assert len(sg.material_specs) == 3
    assert tuple(viewer.engine.envmap.shape) == (8, 16, 3)
    assert int(viewer.engine.mesh.material_id.max()) == 2
