"""The data slice of the PyTorch port against the JAX package on the same
files (CPU): the COLMAP parsers and writers, the NeRF-synthetic, COLMAP and
ScanNet++ datasets view by view, the multi-sensor synthetic rig, the
dataset factory, the shutter metadata, and the port's native image decoder
(built from its own copy of dataloader.cpp) against PIL and the JAX
package's. The on-disk fixtures are those of tests/test_datasets.py and
tests/test_native_loader.py, rebuilt here.

Tolerances and why:
  * parsers, writers, poses, cameras, masks, shutters, split and points:
    exact (the same numpy arithmetic on the same bytes).
  * decoded PNGs against PIL: exact (the port's decoder divides the stored
    8-bit values by 255 in f32, as PIL's caller does). Against the JAX
    package's decoder, which multiplies by f32(1/255): within 1 ulp; so a
    view's ground truth (after alpha compositing on the background) is
    held to the JAX one's within atol 5e-7 (two such ulps of values <= 1
    through one product and one sum).
  * JPEG against PIL: mean |diff| < 0.02 (libjpeg's and PIL's IDCTs may
    round differently), as tests/test_native_loader.py.
  * the multi-sensor rig's ground truth: the port renders it with its fast
    renderer, the JAX package (at 48x48 on the CPU) with its oracle; held
    to golden.compare's rgb rule: |diff| <= 2e-4 + 1e-4 |jax| on all but
    0.1% of the values (at least one), and <= 0.05 everywhere (a hit at an
    acceptance threshold accepted on one side only).

Also asserted on both sides: ROADMAP C9 (the JAX NeRF loader takes a
frame that is not a PNG as its own mask), C10 (the JAX COLMAP loader
reads full-size images with intrinsics scaled for images_N), C12 (the JAX
text reader loses images without 2D points) and C13 (the JAX multi-sensor
rig's rolling-shutter ground truth below 256x256 is a global render).
"""
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from threedgrut_tpu import datasets as jdatasets
from threedgrut_tpu.datasets import colmap as jcolmap
from threedgrut_tpu.datasets import native_loader as jnative_loader
from threedgrut_tpu.datasets import protocols as jprot
from threedgrut_tpu.datasets.dataset_synthetic import \
    SyntheticDataset as JSynthetic
from threedgrut_tpu.datasets.dataset_synthetic import orbit_poses
from threedgrut_torch import datasets as tdatasets
from threedgrut_torch import native as tnative
from threedgrut_torch.cameras import matrix_to_quat
from threedgrut_torch.datasets import colmap as tcolmap
from threedgrut_torch.datasets import native_loader as tnative_loader
from threedgrut_torch.datasets import protocols as tprot
from threedgrut_torch.datasets.dataset_synthetic import \
    SyntheticDataset as TSynthetic


@pytest.fixture(autouse=True, scope="module")
def single_thread():
    """torch on one intra-op thread (the plain renderers' many small ops
    stall an 8-thread pool under the parallel test run's load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def save_png(path, arr):
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


def qvec_tvec(T):
    R_w2c = T[:3, :3].T
    t_w2c = -R_w2c @ T[:3, 3]
    q = matrix_to_quat(torch.tensor(R_w2c)).numpy()
    return q.astype(np.float64), t_w2c.astype(np.float64)


# ---- fixtures --------------------------------------------------------------

@pytest.fixture(scope="module")
def nerf_dir(tmp_path_factory):
    """tests/test_datasets.py's NeRF scene (16x16 RGBA frames, 4 train and
    2 test) with a mask beside train frame 1."""
    d = tmp_path_factory.mktemp("nerf_scene")
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("test", 2)):
        frames = []
        for i in range(n):
            os.makedirs(d / split, exist_ok=True)
            save_png(d / split / f"r_{i}.png",
                     rng.uniform(size=(16, 16, 4)).astype(np.float32))
            c2w = np.eye(4)
            c2w[:3, 3] = [i * 0.1, 0, 4.0]
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(d / f"transforms_{split}.json", "w") as f:
            json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    save_png(d / "train" / "r_1_mask.png",
             (rng.uniform(size=(16, 16)) > 0.5).astype(np.float32))
    return str(d)


CAMERAS = {
    1: ("SIMPLE_PINHOLE", [18.0, 10.0, 6.0]),
    2: ("PINHOLE", [18.0, 17.0, 10.0, 6.0]),
    3: ("OPENCV", [18.0, 17.5, 10.2, 5.9, 0.01, -0.002, 0.001, -0.0005]),
    4: ("OPENCV_FISHEYE", [12.0, 12.0, 10.0, 6.0, 0.03, 0.005, 0.001,
                           0.0002]),
}


def write_colmap(d, n_images=10, cams=CAMERAS, size=(20, 12),
                 image_dir="images", seed=1):
    """A COLMAP scene: `cams` ({id: (model, params)}, all `size`), images
    of an orbit assigned to the cameras in turn, 50 points; the model in
    binary under sparse/0. Returns (points, colors)."""
    os.makedirs(d / "sparse" / "0", exist_ok=True)
    os.makedirs(d / image_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    w, h = size
    cameras = {cid: tcolmap.ColmapCamera(m, w, h, np.array(p))
               for cid, (m, p) in cams.items()}
    images = {}
    for i, T in enumerate(orbit_poses(n_images, radius=3.0)):
        q, t = qvec_tvec(T)
        name = f"img_{i:03d}.png"
        images[i + 1] = tcolmap.ColmapImage(q, t, 1 + i % len(cams), name)
        save_png(d / image_dir / name, rng.uniform(size=(h, w, 3)))
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.uniform(size=(50, 3)).astype(np.float32)
    tcolmap.write_cameras_bin(str(d / "sparse/0/cameras.bin"), cameras)
    tcolmap.write_images_bin(str(d / "sparse/0/images.bin"), images)
    tcolmap.write_points3d_bin(str(d / "sparse/0/points3D.bin"), pts, cols)
    return pts, cols


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("colmap_scene")
    write_colmap(d)
    return str(d)


# ---- shutter metadata ------------------------------------------------------

@pytest.mark.parametrize("spec", ["global", "rolling_top_to_bottom",
                                  "1:global,2:rolling_left_to_right",
                                  {3: "rolling_bottom_to_top", 1: "global"}])
def test_shutter_spec_matches_jax(spec):
    t, j = tprot.parse_shutter_spec(spec), jprot.parse_shutter_spec(spec)
    as_int = (lambda s: {k: int(v) for k, v in s.items()}
              if isinstance(s, dict) else int(s))
    assert as_int(t) == as_int(j)
    for cid in (1, 2, 3, 7):
        assert int(tprot.shutter_for_camera(t, cid)) == int(
            jprot.shutter_for_camera(j, cid))


def test_apply_shutter_matches_jax():
    T = np.eye(4, dtype=np.float32)
    for name in ("global", "rolling_right_to_left"):
        tv = tprot.apply_shutter(tprot.View(T, None, (4, 4), None),
                                 tprot.parse_shutter(name))
        jv = jprot.apply_shutter(jprot.View(T, None, (4, 4), None),
                                 jprot.parse_shutter(name))
        assert int(tv.shutter) == int(jv.shutter)
        assert (tv.pose_end is None) == (jv.pose_end is None)
        if tv.pose_end is not None:
            assert np.array_equal(tv.pose_end, jv.pose_end)


# ---- COLMAP parsers and writers ------------------------------------------

def write_colmap_txt(d, cams, images, pts, cols, points2d="10.5 4.5 -1"):
    with open(d / "cameras.txt", "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cid, c in cams.items():
            f.write(f"{cid} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(x)) for x in c.params) + "\n")
    with open(d / "images.txt", "w") as f:
        f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        for iid, im in images.items():
            f.write(f"{iid} " + " ".join(repr(float(x)) for x in im.qvec)
                    + " " + " ".join(repr(float(x)) for x in im.tvec)
                    + f" {im.camera_id} {im.name}\n{points2d}\n")
    with open(d / "points3D.txt", "w") as f:
        for i, (p, c) in enumerate(zip(pts, cols)):
            f.write(f"{i} " + " ".join(repr(float(x)) for x in p) + " "
                    + " ".join(str(int(x)) for x in c) + " 0.5\n")


@pytest.mark.parametrize("form", ["bin", "txt"])
def test_colmap_parsers_match_jax(tmp_path, colmap_dir, form):
    """Both packages' readers give identical cameras, images and points; in
    binary both packages' writers give identical bytes."""
    sparse = os.path.join(colmap_dir, "sparse/0")
    cams = tcolmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    images = tcolmap.read_images_bin(os.path.join(sparse, "images.bin"))
    pts, cols = tcolmap.read_points3d_bin(
        os.path.join(sparse, "points3D.bin"))
    d = tmp_path / form
    os.makedirs(d)
    if form == "bin":
        for mod in (tcolmap, jcolmap):
            pref = "t" if mod is tcolmap else "j"
            mod.write_cameras_bin(str(d / f"{pref}_cameras.bin"), cams)
            mod.write_images_bin(str(d / f"{pref}_images.bin"), images)
            mod.write_points3d_bin(str(d / f"{pref}_points3D.bin"), pts,
                                   cols)
        for stem in ("cameras", "images", "points3D"):
            assert (d / f"t_{stem}.bin").read_bytes() == \
                (d / f"j_{stem}.bin").read_bytes(), stem
            os.replace(d / f"t_{stem}.bin", d / f"{stem}.bin")
    else:
        write_colmap_txt(d, cams, images, pts,
                         np.round(cols * 255).astype(np.uint8))
    got = tcolmap.load_sparse(str(d))
    want = jcolmap.load_sparse(str(d))
    assert got[0].keys() == want[0].keys() == cams.keys()
    for cid in cams:
        a, b = got[0][cid], want[0][cid]
        assert (a.model, a.width, a.height) == (b.model, b.width, b.height)
        assert np.array_equal(a.params, b.params)
        assert np.array_equal(a.params, cams[cid].params)
    assert got[1].keys() == want[1].keys() == images.keys()
    for iid in images:
        a, b = got[1][iid], want[1][iid]
        assert (a.camera_id, a.name) == (b.camera_id, b.name)
        assert np.array_equal(a.qvec, b.qvec)
        assert np.array_equal(a.tvec, b.tvec)
        assert np.array_equal(a.qvec, images[iid].qvec)
    for x, y in zip(got[2:], want[2:]):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    np.testing.assert_allclose(got[2], pts, atol=1e-6)
    q = images[1].qvec
    assert np.array_equal(tcolmap.qvec_to_rotmat(q),
                          jcolmap.qvec_to_rotmat(q))


# ---- views -----------------------------------------------------------------

CAMERA_FIELDS = {"PinholeCamera": ("focal", "principal", "radial",
                                   "tangential", "thin_prism"),
                 "FisheyeCamera": ("focal", "principal", "radial",
                                   "max_angle")}


def assert_views_equal(tv, jv):
    assert type(tv.camera).__name__ == type(jv.camera).__name__
    for f in CAMERA_FIELDS[type(tv.camera).__name__]:
        a, b = np.asarray(getattr(tv.camera, f)), np.asarray(
            getattr(jv.camera, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert tuple(tv.resolution) == tuple(jv.resolution)
    assert np.array_equal(tv.T_to_world, jv.T_to_world)
    assert tv.rgb_gt.dtype == jv.rgb_gt.dtype
    np.testing.assert_allclose(tv.rgb_gt, np.asarray(jv.rgb_gt), rtol=0,
                               atol=5e-7)
    assert (tv.mask is None) == (jv.mask is None)
    if tv.mask is not None:
        assert np.array_equal(tv.mask, jv.mask)
    assert int(tv.shutter) == int(jv.shutter)
    assert (tv.pose_end is None) == (jv.pose_end is None)
    if tv.pose_end is not None:
        assert np.array_equal(tv.pose_end, jv.pose_end)


def assert_datasets_equal(td, jd):
    assert len(td) == len(jd)
    assert td.scene_extent == jd.scene_extent
    assert np.array_equal(td.observer_points, jd.observer_points)
    for i in range(len(td)):
        assert_views_equal(td[i], jd[i])


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("shutter", ["global", "rolling_top_to_bottom"])
def test_nerf_views_match_jax(nerf_dir, split, shutter):
    kw = dict(split=split, shutter_type=shutter)
    td = tdatasets.make("nerf", nerf_dir, **kw)
    jd = jdatasets.make("nerf", nerf_dir, **kw)
    assert_datasets_equal(td, jd)
    if split == "train":
        assert td[1].mask is not None and td[0].mask is None
    v = td[0]
    assert v.resolution == (16, 16) and v.rgb_gt.shape == (16, 16, 3)
    assert v.T_to_world[1, 1] == -1.0 and v.T_to_world[2, 2] == -1.0


def test_nerf_downsample_matches_jax(nerf_dir):
    td = tdatasets.make("nerf", nerf_dir, downsample_factor=2)
    jd = jdatasets.make("nerf", nerf_dir, downsample_factor=2)
    assert_views_equal(td[0], jd[0])
    assert td[0].resolution == (8, 8)
    assert td[1].mask.shape == (8, 8, 1)     # downsampled with its frame


def test_nerf_c9_frame_is_not_its_own_mask(tmp_path):
    """ROADMAP C9: for a .jpg frame the JAX loader's mask path is the frame
    itself, so the frame's red channel becomes the view's mask; the port
    derives the mask from the stem (no mask here; <stem>_mask.png where
    one is present)."""
    rng = np.random.default_rng(4)
    os.makedirs(tmp_path / "train")
    frames = []
    for i in range(2):
        Image.fromarray((rng.uniform(size=(16, 16, 3)) * 255).astype(
            np.uint8)).save(tmp_path / "train" / f"r_{i}.jpg", quality=95)
        c2w = np.eye(4)
        c2w[:3, 3] = [i * 0.1, 0, 4.0]
        frames.append({"file_path": f"./train/r_{i}.jpg",
                       "transform_matrix": c2w.tolist()})
    with open(tmp_path / "transforms_train.json", "w") as f:
        json.dump({"camera_angle_x": 0.7, "frames": frames}, f)
    mask = (rng.uniform(size=(16, 16)) > 0.5).astype(np.float32)
    save_png(tmp_path / "train" / "r_1_mask.png", mask)

    jd = jdatasets.make("nerf", str(tmp_path))
    td = tdatasets.make("nerf", str(tmp_path))
    # JAX: the frame is its own mask (its red channel).
    assert jd[0].mask is not None
    assert np.array_equal(jd[0].mask[..., 0], np.asarray(jd[0].rgb_gt)[..., 0])
    assert 0.2 < float(jd[0].mask.mean()) < 0.8
    assert jd[1].mask is not None and not np.array_equal(
        jd[1].mask[..., 0], mask)
    # The port: no mask for frame 0, the real mask for frame 1.
    assert td[0].mask is None
    assert np.array_equal(td[1].mask[..., 0], mask)
    np.testing.assert_allclose(td[0].rgb_gt, np.asarray(jd[0].rgb_gt),
                               rtol=0, atol=5e-7)


@pytest.mark.parametrize("split", ["train", "val"])
def test_colmap_views_match_jax(colmap_dir, split):
    """All four camera models (one per sensor), the split, the views and
    the initialization points, with a per-camera shutter spec."""
    kw = dict(split=split, shutter_type="1:global,2:rolling_top_to_bottom,"
              "4:rolling_left_to_right")
    td = tdatasets.make("colmap", colmap_dir, **kw)
    jd = jdatasets.make("colmap", colmap_dir, **kw)
    assert len(td) == (8 if split == "train" else 2)
    assert [im.name for im in td.images] == [im.name for im in jd.images]
    assert_datasets_equal(td, jd)
    models = {type(td.cameras[c]).__name__ for c in td.cameras}
    assert models == {"PinholeCamera", "FisheyeCamera"}
    for a, b in zip(td.initialization_points(), jd.initialization_points()):
        assert np.array_equal(a, b)
    shutters = {im.camera_id: int(td[i].shutter)
                for i, im in enumerate(td.images)}
    assert shutters.get(2, 1) == 1 and shutters.get(1, 0) == 0


def test_colmap_c12_images_without_2d_points(tmp_path, colmap_dir):
    """ROADMAP C12: in images.txt an image without 2D points has an empty
    second line. The JAX reader drops empty lines before pairing, so it
    reads the next image's pose line as 2D points and loses every other
    image; the port reads each image."""
    sparse = os.path.join(colmap_dir, "sparse/0")
    cams = tcolmap.read_cameras_bin(os.path.join(sparse, "cameras.bin"))
    images = tcolmap.read_images_bin(os.path.join(sparse, "images.bin"))
    pts, cols = tcolmap.read_points3d_bin(
        os.path.join(sparse, "points3D.bin"))
    write_colmap_txt(tmp_path, cams, images, pts,
                     np.round(cols * 255).astype(np.uint8), points2d="")
    got = tcolmap.read_images_txt(str(tmp_path / "images.txt"))
    want = jcolmap.read_images_txt(str(tmp_path / "images.txt"))
    assert sorted(got) == sorted(images)
    for iid, im in images.items():
        assert got[iid].name == im.name
        assert np.array_equal(got[iid].qvec, im.qvec)
    assert sorted(want) == sorted(images)[0::2]


def test_colmap_text_model_and_scannetpp_match_jax(tmp_path):
    """ScanNet++'s layout: a text model under colmap/ and the images under
    undistorted_images/."""
    write_colmap(tmp_path, n_images=9, image_dir="undistorted_images",
                 seed=5)
    sp = tmp_path / "sparse/0"
    cams = tcolmap.read_cameras_bin(str(sp / "cameras.bin"))
    images = tcolmap.read_images_bin(str(sp / "images.bin"))
    pts, cols = tcolmap.read_points3d_bin(str(sp / "points3D.bin"))
    os.makedirs(tmp_path / "colmap")
    write_colmap_txt(tmp_path / "colmap", cams, images, pts,
                     np.round(cols * 255).astype(np.uint8))
    for split in ("train", "val"):
        td = tdatasets.make("scannetpp", str(tmp_path), split=split)
        jd = jdatasets.make("scannetpp", str(tmp_path), split=split)
        assert type(td).__name__ == type(jd).__name__ == "ScannetppDataset"
        assert_datasets_equal(td, jd)
        for a, b in zip(td.initialization_points(),
                        jd.initialization_points()):
            assert np.array_equal(a, b)


def test_colmap_c10_missing_images_n(tmp_path):
    """ROADMAP C10: with downsample_factor=4 and no images_4/, the JAX
    loader reads the 80x48 images of images/ with intrinsics scaled by 1/4
    (focal 18 for 72); the port raises FileNotFoundError naming images_4.
    With images_4/ present both read it, identically."""
    write_colmap(tmp_path, cams={1: ("PINHOLE", [72.0, 72.0, 40.0, 24.0])},
                 size=(80, 48), seed=6)
    jd = jdatasets.make("colmap", str(tmp_path), downsample_factor=4)
    v = jd[0]
    assert v.resolution == (80, 48)
    assert np.array_equal(np.asarray(v.camera.focal), [18.0, 18.0])
    assert np.array_equal(np.asarray(v.camera.principal), [10.0, 6.0])
    with pytest.raises(FileNotFoundError, match="images_4"):
        tdatasets.make("colmap", str(tmp_path), downsample_factor=4)

    os.makedirs(tmp_path / "images_4")
    for name in os.listdir(tmp_path / "images"):
        with Image.open(tmp_path / "images" / name) as im:
            im.resize((20, 12)).save(tmp_path / "images_4" / name)
    td = tdatasets.make("colmap", str(tmp_path), downsample_factor=4)
    jd = jdatasets.make("colmap", str(tmp_path), downsample_factor=4)
    assert_datasets_equal(td, jd)
    assert td[0].resolution == (20, 12)
    # An images_N folder at another size than the camera's over N.
    with Image.open(tmp_path / "images_4" / td.images[0].name) as im:
        im.resize((40, 24)).save(tmp_path / "images_4" / td.images[0].name)
    with pytest.raises(ValueError, match="downsample_factor"):
        tdatasets.make("colmap", str(tmp_path), downsample_factor=4)[0]


# ---- the multi-sensor rig --------------------------------------------------

def rgb_within(got, want):
    """golden.compare's rgb rule (module docstring): (loose values, values,
    max |diff|)."""
    a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(a - b)
    return int((d > 2e-4 + 1e-4 * np.abs(b)).sum()), d.size, float(d.max())


def jax_fast_rgb(view, scene, cache):
    """The JAX package's fast renderer on a view's camera, pose pair and
    shutter (what its rig renders above 256x256), jitted once per camera
    model and shutter in `cache`."""
    import jax
    import jax.numpy as jnp
    from threedgrut_tpu.cameras import SensorPose, ShutterType
    from threedgrut_tpu.cameras import pose_from_matrix as jpose
    from threedgrut_tpu.render import gut as jgut
    key = (type(view.camera).__name__, int(view.shutter))
    if key not in cache:
        def fn(T, T_end, cam, *scene):
            p0, p1 = jpose(T), jpose(T_end)
            return jgut.render(
                *scene, cam,
                SensorPose(p0.q_start, p0.t_start, p1.q_start, p1.t_start),
                tuple(view.resolution), 1 << 16,
                shutter=ShutterType(key[1]), sh_degree=3)
        cache[key] = jax.jit(fn)
    out, ovf = cache[key](jnp.asarray(view.T_to_world),
                          jnp.asarray(view.pose_end),
                          jax.tree.map(jnp.asarray, view.camera),
                          *(jnp.asarray(x) for x in scene))
    assert not bool(ovf)
    return np.clip(np.asarray(out.rgb), 0.0, 1.0)


def test_multi_sensor_rig_matches_jax():
    """Cameras, poses, end poses, shutters and masks exact; the ground
    truth of the global-shutter views within golden.compare's rgb rule of
    the JAX oracle's. ROADMAP C13: the JAX rig renders its ground truth
    with the oracle below 256x256 on the CPU, whose rays all leave from the
    start pose, so its rolling-shutter views there are global-shutter
    renders; the port renders every view with its fast renderer (as the
    JAX rig does above 256x256), and its rolling views are held to the JAX
    fast renderer's."""
    kw = dict(num_views=8, resolution=(48, 48), num_gt_gaussians=48, seed=3,
              multi_sensor=True)
    td = TSynthetic(device="cpu", **kw)
    jd = JSynthetic(**kw)
    assert len(td) == len(jd) == 8
    assert td.scene_extent == jd.scene_extent
    assert np.array_equal(td.observer_points, jd.observer_points)
    kinds = [type(td[i].camera).__name__ for i in range(8)]
    assert kinds[:2] == ["PinholeCamera", "FisheyeCamera"]
    assert [int(td[i].shutter) for i in range(4)] == [0, 0, 1, 1]
    loose = values = 0
    cache = {}
    for i in range(8):
        tv, jv = td[i], jd[i]
        want = np.asarray(jv.rgb_gt)
        if int(jv.shutter):
            fast = jax_fast_rgb(jv, jd.scene, cache)
            # C13: the JAX rig's rolling view is no rolling render.
            assert rgb_within(want, fast)[2] > 0.1
            want = fast
        n_loose, n, dmax = rgb_within(tv.rgb_gt, want)
        assert dmax <= 0.05, (i, dmax)
        loose, values = loose + n_loose, values + n
        assert want.mean() > 1e-4
        tv.rgb_gt = np.asarray(jv.rgb_gt)
        assert_views_equal(tv, jv)
    assert loose <= max(1, math.floor(1e-3 * values)), loose
    assert not np.allclose(td[2].pose_end, td[2].T_to_world)


# ---- the factory -----------------------------------------------------------

@pytest.mark.parametrize("name,cls", [
    ("nerf", "NeRFDataset"), ("nerf_synthetic", "NeRFDataset"),
    ("blender", "NeRFDataset"), ("colmap", "ColmapDataset"),
    ("synthetic", "SyntheticDataset"), ("nope", None)])
def test_make_dispatch_matches_jax(nerf_dir, colmap_dir, name, cls):
    path = colmap_dir if name == "colmap" else nerf_dir
    # The synthetic scene ignores keywords its constructor does not name.
    kw = (dict(num_views=2, resolution=(16, 16), num_gt_gaussians=8,
               downsample_factor=3, shutter_type="global")
          if name == "synthetic" else {})
    if cls is None:
        for make in (tdatasets.make, jdatasets.make):
            with pytest.raises(ValueError, match="unknown dataset type"):
                make(name, path)
        return
    td = tdatasets.make(name, path, device="cpu", **kw)
    jd = jdatasets.make(name, path, **kw)
    assert type(td).__name__ == type(jd).__name__ == cls
    assert len(td) == len(jd)


# ---- the native decoder ----------------------------------------------------

@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    """tests/test_native_loader.py's images: RGB, RGBA and L PNGs and a
    JPEG, 13x17."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    paths = []
    for i, mode in enumerate(("RGB", "RGBA", "L")):
        arr = (rng.uniform(size=(13, 17, {"RGB": 3, "RGBA": 4, "L": 1}[mode]))
               * 255).astype(np.uint8)
        p = str(d / f"img_{i}.png")
        Image.fromarray(arr.squeeze(), mode=mode).save(p)
        paths.append(p)
    jp = str(d / "img.jpg")
    Image.fromarray((rng.uniform(size=(13, 17, 3)) * 255)
                    .astype(np.uint8)).save(jp, quality=95)
    paths.append(jp)
    return paths


def test_native_decoder_is_the_ports_own_build():
    lib = tnative.load_library()
    assert lib is not None, tnative.build_error()
    assert tnative_loader.decoder_name() == "native"
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "build"
    assert "threedgrut_tpu" not in str(path)
    assert os.path.basename(lib._name) == path.name


def test_native_png_matches_pil_and_jax(pngs):
    loader = tnative_loader.ImageLoader(n_threads=2)
    jloader = jnative_loader.ImageLoader(n_threads=2)
    assert loader.native
    for p in pngs[:3]:
        a = loader.decode(p)
        b = tnative_loader._pil_decode(p)
        if b.ndim == 2:     # PIL grey -> the native decoder expands to RGB
            b = np.repeat(b[..., None], 3, -1)
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a, b), p
        np.testing.assert_array_max_ulp(a, jloader.decode(p), maxulp=1)


def test_native_jpeg(pngs):
    loader = tnative_loader.ImageLoader(n_threads=2)
    a = loader.decode(pngs[-1])
    b = tnative_loader._pil_decode(pngs[-1])
    assert a.shape == b.shape
    assert np.abs(a - b).mean() < 0.02


def test_prefetch_pipeline(pngs):
    loader = tnative_loader.ImageLoader(n_threads=4)
    loader.prefetch(pngs)
    for p in reversed(pngs):
        img = loader.get(p)
        assert img.ndim == 3 and img.dtype == np.float32
        assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0
        assert np.array_equal(img, loader.decode(p))
    loader.close()


def test_pil_decoder_where_the_library_is_missing(pngs, monkeypatch):
    """Without the library the loader decodes with PIL, and says so."""
    monkeypatch.setattr(tnative_loader, "load_library", lambda: None)
    loader = tnative_loader.ImageLoader(n_threads=2)
    assert not loader.native
    assert tnative_loader.decoder_name() == "pil"
    for p in pngs:
        assert np.array_equal(loader.get(p), tnative_loader._pil_decode(p))
