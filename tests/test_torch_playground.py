"""The port's playground (threedgrut_torch/playground/) against the JAX
package's on the same numpy inputs: environment maps, materials (`bounce`
over the four kinds, with a texture and a normal map), meshes and the
plain M1 (mesh closest-hit), the denoisers, the engine's camera rays and
depth of field given JAX's own draws, and Engine.render (a mirror quad,
max_bounces 2, spp 1) and Engine.render_hybrid end to end on
tests/test_playground.py's 48-particle scene at 16x16. The two JAX engine
calls are module fixtures (~20 s each: the Pallas compositors in
interpret mode).

Tolerances: mesh faces, material ids and hit flags exactly equal; the
mesh, material and ray floats within 1e-5 (the same f32 expressions; XLA
may contract a product and a sum into one fused multiply-add where torch
rounds twice); the bilateral filter within 1e-5;
the a-trous filter within ATROUS_ATOL; the engine's frames within
`frame_agrees` (golden.compare's rule: 2e-4 + 1e-4 relative on all but
0.1% of the values, at least one, for a hit at an acceptance threshold on
one side only)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_cameras import make_pinhole
from tests.test_gut_reference import random_scene
from tests.test_torch_grt import single_thread  # noqa: F401 (autouse)
from threedgrut_torch.cameras import FisheyeCamera, PinholeCamera
from threedgrut_torch.ops import mesh_intersect as tmi
from threedgrut_torch.playground import denoiser as tden
from threedgrut_torch.playground import engine as teng
from threedgrut_torch.playground import envmap as tenv
from threedgrut_torch.playground import materials as tmat
from threedgrut_torch.playground import mesh as tmesh
from threedgrut_tpu import cameras as jcams
from threedgrut_tpu.playground import denoiser as jden
from threedgrut_tpu.playground import engine as jeng
from threedgrut_tpu.playground import envmap as jenv
from threedgrut_tpu.playground import materials as jmat
from threedgrut_tpu.playground import mesh as jmesh

RES = (16, 16)
ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread for the module (as
    tests/test_torch_grt.py): under the parallel run's load, the plain
    versions' many small ops stall on an 8-thread pool's barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def npy(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def t(x):
    return torch.tensor(np.asarray(x))


def port_mesh(jm):
    return tmesh.from_numpy({f: np.asarray(getattr(jm, f))
                             for f in tmesh.FIELDS}, "cpu")


def port_materials(jm):
    return tmat.from_numpy({f: np.asarray(getattr(jm, f))
                            for f in tmat.FIELDS}, "cpu")


def port_camera(jc):
    kind = PinholeCamera if isinstance(jc, jcams.PinholeCamera) \
        else FisheyeCamera
    return kind(*(t(x).to(torch.float32) for x in jc))


def frame_agrees(got, want):
    """golden.compare's rule on one field: within 2e-4 + 1e-4 |want| on all
    but 0.1% of the values (at least one)."""
    d = np.abs(npy(got).astype(np.float64) - npy(want).astype(np.float64))
    loose = int((d > 2e-4 + 1e-4 * np.abs(npy(want))).sum())
    return loose <= max(1, math.floor(1e-3 * d.size)), (float(d.max()),
                                                         loose)


# ---- scene of tests/test_playground.py's mirror-floor test --------------

def mirror_scene():
    jm = jmesh.make_quad([0.0, 1.2, 3.0], [4.0, 0, 0], [0, 0, 4.0],
                         material_id=0)
    mats = jmat.make_materials(
        [dict(kind=jmat.MaterialKind.MIRROR, base_color=(1.0, 1.0, 1.0))])
    return jm, mats


def hybrid_scene():
    jm = jmesh.make_quad([0.0, 0.0, 5.0], [3.0, 0, 0], [0, 3.0, 0],
                         material_id=0)
    mats = jmat.make_materials(
        [dict(kind=jmat.MaterialKind.MIRROR, base_color=(1.0, 1.0, 1.0))])
    return jm, mats


CFG = dict(max_bounces=2, candidate_capacity=48)


@pytest.fixture(scope="module")
def jax_frames():
    """JAX's Engine.render (mirror floor) and render_hybrid (mirror
    wall, HYBRID_T's camera), each once."""
    cam = make_pinhole(f=30.0, cx=8.0, cy=8.0)
    out = {}
    for name, scene_fn, seed in (("render", mirror_scene, 2),
                                 ("hybrid", hybrid_scene, 4)):
        g = random_scene(n=48, seed=seed)
        jm, mats = scene_fn()
        e = jeng.Engine(*g, mesh=jm, materials=mats,
                        config=jeng.EngineConfig(**CFG))
        if name == "render":
            res = e.render(cam, jnp.eye(4), RES)
        else:
            res = e.render_hybrid_jit(cam, jnp.asarray(HYBRID_T), RES)
        out[name] = ({k: np.asarray(v) for k, v in res.items()},
                     tuple(np.asarray(x) for x in g), jm, mats)
    return cam, out


def port_engine(g, jm, mats):
    return teng.Engine(*(t(x) for x in g), mesh=port_mesh(jm),
                       materials=port_materials(mats),
                       config=teng.EngineConfig(**CFG), device="cpu")


def test_engine_render_matches_jax(jax_frames):
    cam, runs = jax_frames
    want, g, jm, mats = runs["render"]
    got = port_engine(g, jm, mats).render(port_camera(cam), torch.eye(4),
                                          RES)
    assert not bool(got["overflow"])
    assert float(npy(got["rgb"]).max()) > 0.05
    for k in ("rgb", "opacity", "depth"):
        ok, rep = frame_agrees(got[k], want[k])
        assert ok, (k, rep)


def primary_hits(mesh, cam, T, resolution):
    """The port's mesh hits of the hybrid's primary rays (tile order)."""
    from threedgrut_torch.cameras import pose_from_matrix
    from threedgrut_torch.render import gut as tgut
    w, h = resolution
    grid = (-(-w // 16), -(-h // 16))
    rays_pk = tgut.packed_world_rays(cam, pose_from_matrix(T), grid, T)
    o = rays_pk[:, 0:3, :].transpose(1, 2).reshape(-1, 3)
    d = rays_pk[:, 3:6, :].transpose(1, 2).reshape(-1, 3)
    return o, d, tmesh.intersect(mesh, o, d)


def edge_share(hit) -> float:
    """The share of rays that meet the mesh within 1e-6 (barycentric) of
    a face's edge."""
    u, v = hit.bary[:, 0], hit.bary[:, 1]
    near = (torch.minimum(torch.minimum(u, v), 1 - u - v) < 1e-6) \
        & torch.isfinite(hit.t)
    return float(near.float().mean())


# The hybrid test's camera, moved off the mirror's axis: with the identity
# pose the mirror's diagonal passes exactly through 16 of the 256 rays (see
# test_shared_edge_rays_differ_by_rounding).
HYBRID_T = np.array([[1, 0, 0, 0.0173], [0, 1, 0, -0.0291], [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float32)


def test_engine_render_hybrid_matches_jax(jax_frames):
    cam, runs = jax_frames
    want, g, jm, mats = runs["hybrid"]
    eng = port_engine(g, jm, mats)
    got = eng.render_hybrid(port_camera(cam), t(HYBRID_T), RES)
    assert not bool(got["overflow"]) and not bool(want["overflow"])
    assert float(npy(got["depth"]).max()) <= 6.0
    _, _, hit = primary_hits(eng.mesh, port_camera(cam), t(HYBRID_T), RES)
    assert edge_share(hit) == 0.0 and np.isfinite(npy(hit.t)).mean() > 0.5
    for k in ("rgb", "opacity", "depth"):
        ok, rep = frame_agrees(got[k], want[k])
        assert ok, (k, rep)


def test_shared_edge_rays_differ_by_rounding():
    """A tolerated divergence (ROADMAP): a ray through the shared edge of
    two faces hits one of them or, by a rounding on both, neither. XLA
    contracts the test's products and sums into fused multiply-adds inside
    its fusion; the port, and M1 built with --fmad=false, round each
    operation. On the hybrid scene's mirror seen head-on, the diagonal
    passes exactly through 16 primary rays: the port gives each the
    exact barycentric 0 and the first face; JAX takes the other face on
    some and misses through the crack on others."""
    cam = make_pinhole(f=30.0, cx=8.0, cy=8.0)
    jm, _ = hybrid_scene()
    o, d, hit = primary_hits(port_mesh(jm), port_camera(cam), torch.eye(4),
                             RES)
    want = jmesh.intersect(jm, jnp.asarray(npy(o)), jnp.asarray(npy(d)))
    u = npy(hit.bary)[:, 0]
    diagonal = np.isfinite(npy(hit.t)) & (u == 0.0)
    assert diagonal.sum() == 16 and (npy(hit.face)[diagonal] == 0).all()
    jf = np.asarray(want.face)
    np.testing.assert_array_equal(jf[~diagonal], npy(hit.face)[~diagonal])
    assert (jf[diagonal] == -1).any() and (jf[diagonal] != 0).any()


def test_render_fitted_grows_until_the_frame_fits(jax_frames):
    """C15 in the port: a candidate capacity too small for the scene sets
    `overflow`; render_fitted doubles it until the frame fits, and the
    fitted frame is the frame at a capacity that fits."""
    cam, runs = jax_frames
    _, g, jm, mats = runs["render"]
    small = port_engine(g, jm, mats)
    small.cfg.candidate_capacity = 8
    assert bool(small.render(port_camera(cam), torch.eye(4),
                             RES)["overflow"])
    grown = []
    fitted = small.render_fitted(port_camera(cam), torch.eye(4), RES,
                                 grown=grown)
    assert grown and grown[-1] == small.cfg.candidate_capacity
    assert not bool(fitted["overflow"])
    ref = port_engine(g, jm, mats)
    ref.cfg.candidate_capacity = grown[-1]
    np.testing.assert_array_equal(
        npy(fitted["rgb"]),
        npy(ref.render(port_camera(cam), torch.eye(4), RES)["rgb"]))


# ---- envmap, materials ----------------------------------------------------

def test_envmap_and_tonemaps_match_jax():
    rng = np.random.default_rng(0)
    env = rng.uniform(0, 2, (8, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs[:3] = [[0, 0, 1], [0, 0, -1], [-1, 0, 0]]   # poles and the seam
    np.testing.assert_allclose(
        npy(tenv.sample_envmap(t(env), t(dirs))),
        np.asarray(jenv.sample_envmap(jnp.asarray(env), jnp.asarray(dirs))),
        atol=ATOL)
    np.testing.assert_allclose(
        npy(tenv.sample_envmap(None, t(dirs), (0.1, 0.2, 0.3))),
        np.asarray(jenv.sample_envmap(None, jnp.asarray(dirs),
                                      (0.1, 0.2, 0.3))))
    x = rng.uniform(-0.5, 4, (100,)).astype(np.float32)
    np.testing.assert_allclose(npy(tenv.filmic_tonemap(t(x))),
                               np.asarray(jenv.filmic_tonemap(x)),
                               atol=ATOL)
    np.testing.assert_allclose(npy(tenv.linear_to_srgb(t(x))),
                               np.asarray(jenv.linear_to_srgb(x)),
                               atol=ATOL)


def material_specs(rng):
    tex = rng.uniform(0, 1, (4, 6, 3)).astype(np.float32)
    ntex = rng.uniform(0.2, 0.8, (5, 3, 3)).astype(np.float32)
    ntex[..., 2] = 1.0
    return [
        dict(kind=jmat.MaterialKind.DIFFUSE, base_color=(0.7, 0.5, 0.3),
             base_color_texture=tex, emissive=(0.1, 0.0, 0.0)),
        dict(kind=jmat.MaterialKind.MIRROR, base_color=(0.9, 0.9, 0.9),
             normal_texture=ntex),
        dict(kind=jmat.MaterialKind.GLASS, ior=1.45,
             base_color=(1.0, 0.95, 0.9)),
        dict(kind=jmat.MaterialKind.PBR, metallic=0.4, roughness=0.3,
             base_color=(0.2, 0.6, 0.9), base_color_texture=tex,
             normal_texture=ntex),
    ]


def test_make_materials_matches_jax():
    specs = material_specs(np.random.default_rng(1))
    want = jmat.make_materials(specs)
    got = tmat.make_materials(specs, "cpu")
    for f in tmat.FIELDS:
        np.testing.assert_array_equal(npy(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)


def test_bounce_matches_jax_over_every_kind():
    """bounce over the four kinds, entering and leaving (glass's total
    internal reflection included), with a base-colour texture and a normal
    map, and with and without uv/tangent."""
    rng = np.random.default_rng(2)
    specs = material_specs(rng)
    jm = jmat.make_materials(specs)
    tm = port_materials(jm)
    r = 256
    mid = rng.integers(-1, 5, r).astype(np.int32)   # clipped like JAX
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    n = rng.normal(size=(r, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    env = rng.uniform(0, 1, (r, 3)).astype(np.float32)
    uv = rng.uniform(-1.5, 2.5, (r, 2)).astype(np.float32)   # wraps
    tan = np.cross(n, rng.normal(size=(r, 3))).astype(np.float32)
    tan /= np.linalg.norm(tan, axis=-1, keepdims=True)
    for kw_j, kw_t in (({}, {}),
                       (dict(uv=jnp.asarray(uv)), dict(uv=t(uv))),
                       (dict(uv=jnp.asarray(uv), tangent=jnp.asarray(tan)),
                        dict(uv=t(uv), tangent=t(tan)))):
        want = jmat.bounce(jm, jnp.asarray(mid), jnp.asarray(d),
                           jnp.asarray(n), jnp.asarray(env), **kw_j)
        got = tmat.bounce(tm, t(mid), t(d), t(n), t(env), **kw_t)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(npy(g), np.asarray(w), atol=ATOL)
        np.testing.assert_array_equal(npy(got[3]), np.asarray(want[3]))
    assert npy(got[3]).any() and not npy(got[3]).all()


# ---- meshes and M1 --------------------------------------------------------

def props():
    """A glass icosphere (subdivision 2) and a UV-mapped quad behind it."""
    sph = jmesh.make_icosphere([0.1, -0.2, 3.0], 0.8, subdivisions=2,
                               material_id=1)
    quad = jmesh.make_mesh(
        np.array([[-2, -2, 5], [2, -2, 5], [2, 2, 5.5], [-2, 2, 5.5]],
                 np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
    return jmesh.merge_meshes([quad, sph])


def test_mesh_builders_match_jax(tmp_path):
    jm = props()
    tm = tmesh.merge_meshes([
        tmesh.make_mesh(
            np.array([[-2, -2, 5], [2, -2, 5], [2, 2, 5.5], [-2, 2, 5.5]],
                     np.float32), np.array([[0, 1, 2], [0, 2, 3]], np.int32),
            uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
            device="cpu"),
        tmesh.make_icosphere([0.1, -0.2, 3.0], 0.8, subdivisions=2,
                             material_id=1, device="cpu")])
    assert tm.num_faces == jm.num_faces == 2 + 320
    for f in tmesh.FIELDS:
        np.testing.assert_array_equal(npy(getattr(tm, f)),
                                      np.asarray(getattr(jm, f)), f)
    path = tmp_path / "m.obj"
    v, fa = np.asarray(jm.vertices), np.asarray(jm.faces)
    path.write_text("".join(f"v {a} {b} {c}\n" for a, b, c in v)
                    + "".join(f"f {a + 1} {b + 1}/1 {c + 1}//2\n"
                              for a, b, c in fa))
    got, want = tmesh.load_obj(str(path), 3, "cpu"), jmesh.load_obj(str(path),
                                                                   3)
    for f in tmesh.FIELDS:
        np.testing.assert_array_equal(npy(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    q = tmesh.make_quad([0, 0, 2.0], [1, 0, 0], [0, 1, 0], 2, "cpu")
    jq = jmesh.make_quad([0, 0, 2.0], [1, 0, 0], [0, 1, 0], 2)
    for f in tmesh.FIELDS:
        np.testing.assert_array_equal(npy(getattr(q, f)),
                                      np.asarray(getattr(jq, f)), f)


def rays(n, seed):
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.0, -0.5]], np.float32), (n, 1))
    o += rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    d = np.stack([rng.uniform(-0.45, 0.45, n), rng.uniform(-0.45, 0.45, n),
                  np.ones(n)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[-4:] = 0.0                                   # inactive rays miss
    return o, d


def assert_hits_equal(got, want):
    np.testing.assert_array_equal(npy(got.face), np.asarray(want.face))
    np.testing.assert_array_equal(npy(got.material_id),
                                  np.asarray(want.material_id))
    np.testing.assert_allclose(npy(got.t), np.asarray(want.t), rtol=ATOL)
    for k in ("normal", "bary", "uv", "tangent"):
        np.testing.assert_allclose(npy(getattr(got, k)),
                                   np.asarray(getattr(want, k)), atol=ATOL,
                                   err_msg=k)


def test_mesh_intersect_matches_jax():
    """Plain M1 and the interpolation against JAX's intersect: faces and
    materials exact, floats within 1e-5; from inside the sphere too
    (t_min)."""
    jm = props()
    tm = port_mesh(jm)
    o, d = rays(509, 3)
    want = jmesh.intersect(jm, jnp.asarray(o), jnp.asarray(d))
    got = tmesh.intersect(tm, t(o), t(d))
    assert_hits_equal(got, want)
    hit = np.isfinite(npy(got.t))
    assert 100 < hit.sum() < len(o) - 4 and not hit[-4:].any()
    inside = np.tile(np.array([[0.1, -0.2, 3.0]], np.float32), (64, 1))
    want = jmesh.intersect(jm, jnp.asarray(inside), jnp.asarray(d[:64]))
    got = tmesh.intersect(tm, t(inside), t(d[:64]))
    assert_hits_equal(got, want)
    assert bool(tmesh.intersect(None, t(o), t(d)).face.eq(-1).all())


def test_mesh_intersect_ties_take_the_lowest_face(monkeypatch):
    """Exact ties: rays through the shared diagonal of a quad (integer
    corners, dyadic hit points: both faces give the same t bit for bit)
    and through a face duplicated at a higher index. Both packages take the
    lowest face index, with the plain M1 chunked over rays and faces."""
    v = np.array([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]],
                 np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3], [3, 2, 0], [0, 1, 2]], np.int32)
    jm = jmesh.make_mesh(v, f)
    xs = np.array([-0.5, -0.25, 0.0, 0.25, 0.5, 0.75], np.float32)
    o = np.stack([xs, xs, np.zeros_like(xs)], -1)          # on the diagonal
    o = np.concatenate([o, [[0.5, -0.5, 0.0], [-0.5, 0.5, 0.0]]]
                       ).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (len(o), 1))
    want = jmesh.intersect(jm, jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(want.face),
                                  [0] * 6 + [0, 1])
    got = tmesh.intersect(port_mesh(jm), t(o), t(d))
    assert_hits_equal(got, want)
    tri = tmi.triangles(t(v), t(f))
    whole = tmi.closest_hits_plain(t(o), t(d), tri)
    for fc, pairs in ((1, 1), (2, 4), (3, 6)):
        monkeypatch.setattr(tmi, "FACE_CHUNK", fc)
        monkeypatch.setattr(tmi, "PAIRS_PER_CHUNK", pairs)
        chunked = tmi.closest_hits_plain(t(o), t(d), tri)
        np.testing.assert_array_equal(npy(chunked[1]), np.asarray(want.face))
        for a, b in zip(chunked, whole):
            np.testing.assert_array_equal(npy(a), npy(b))


# ---- denoisers --------------------------------------------------------------

# The a-trous filter's colour weights are exp(-|dl| / (4 sigma)), sigma
# from a 3x3 variance E[l^2] - E[l]^2 that cancels: an ulp of the two
# packages' sums moves a weight by up to ~1e-4 relative over four passes.
ATROUS_ATOL = 2e-4


def test_denoisers_match_jax():
    rng = np.random.default_rng(4)
    clean = np.zeros((20, 24, 3), np.float32)
    clean[:, 12:] = 0.9
    noisy = (clean + rng.normal(0, 0.15, clean.shape)).astype(np.float32)
    depth = np.where(np.arange(24)[None, :] >= 12, 2.0, 1.0).astype(
        np.float32) * np.ones((20, 24), np.float32)
    depth[3, 4] = np.inf                       # a pixel with no depth
    for kw in ({}, dict(depth=True)):
        dj = jnp.asarray(depth) if kw else None
        dt = t(depth) if kw else None
        np.testing.assert_allclose(
            npy(tden.bilateral_denoise(t(noisy), dt)),
            np.asarray(jden.bilateral_denoise(jnp.asarray(noisy), dj)),
            atol=ATOL)
        np.testing.assert_allclose(
            npy(tden.atrous_denoise(t(noisy), dt)),
            np.asarray(jden.atrous_denoise(jnp.asarray(noisy), dj)),
            atol=ATROUS_ATOL)


# ---- camera rays and depth of field -----------------------------------------

def test_camera_rays_and_dof_given_jax_draws():
    """_camera_rays with spp jitter and depth of field, pinhole and
    fisheye, given the draws JAX's _camera_rays makes from its key."""
    g = random_scene(n=4, seed=0)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    T[:3, 3] = [0.3, -0.2, 0.5]
    key = jax.random.PRNGKey(11)
    w, h = 12, 8
    jitter = np.asarray(jax.random.uniform(key, (h, w, 2)))
    _, sub = jax.random.split(key)
    lens = np.asarray(jax.random.uniform(sub, (h, w, 2)))
    fish = jcams.FisheyeCamera(focal=jnp.array([9.0, 9.0]),
                               principal=jnp.array([6.0, 4.0]),
                               radial=jnp.array([0.01, 0.0, 0.0, 0.0]),
                               max_angle=jnp.asarray(1.2))
    for cam in (make_pinhole(f=10.0, cx=6.0, cy=4.0), fish):
        for dof in (False, True):
            cfg = dict(spp=2, use_dof=dof, aperture=0.05, focus_z=2.0)
            je = jeng.Engine(*g, config=jeng.EngineConfig(**cfg))
            te = teng.Engine(*(t(np.asarray(x)) for x in g),
                             config=teng.EngineConfig(**cfg), device="cpu")
            wo, wd = je._camera_rays(cam, jnp.asarray(T), (w, h), key,
                                     jitter=True)
            go, gd = te._camera_rays(port_camera(cam), t(T), (w, h),
                                     t(jitter), t(lens) if dof else None)
            np.testing.assert_allclose(npy(go), np.asarray(wo), atol=ATOL)
            np.testing.assert_allclose(npy(gd), np.asarray(wd), atol=ATOL)
    # The generator's draws have the shapes and the range of JAX's.
    te = teng.Engine(*(t(np.asarray(x)) for x in g),
                     config=teng.EngineConfig(spp=2, use_dof=True),
                     device="cpu")
    jit_draw, lens_draw = te.draws((w, h))
    assert jit_draw.shape == lens_draw.shape == (h, w, 2)
    assert 0.0 <= float(jit_draw.min()) and float(lens_draw.max()) < 1.0


def test_render_traces_in_image_blocks():
    """Engine.render traces its rays in 16x16 tiles, the tiles block by
    block (engine.block_order), and puts each result back at its pixel: at
    272x32 (two blocks of tiles across) its one-bounce frame equals, bit
    for bit, grt.trace of the frame's camera rays in row-major tile order
    (below 8192 particles each bundle is culled on its own, so the order
    of the tiles does not matter)."""
    from threedgrut_torch.render import grt as tgrt
    from threedgrut_torch.render import gut as tgut
    g = tuple(t(np.asarray(x)) for x in random_scene(n=48, seed=2))
    res, grid = (272, 32), (17, 2)
    cam = PinholeCamera(torch.tensor([200.0, 200.0]),
                        torch.tensor([136.0, 16.0]), torch.zeros(6),
                        torch.zeros(2), torch.zeros(4))
    order = teng.block_order(grid, "cpu")
    assert sorted(order.tolist()) == list(range(34))
    assert order[:16].tolist() == list(range(16)) and \
        order[16:32].tolist() == list(range(17, 33))
    eng = teng.Engine(*g, config=teng.EngineConfig(max_bounces=1,
                                                   candidate_capacity=48),
                      device="cpu")
    got = eng.render(cam, torch.eye(4), res)
    o, d = eng._camera_rays(cam, torch.eye(4), res)
    rays = tgut.tile_pack(torch.cat([o, d], -1).reshape(32, 272, 6),
                          grid).transpose(1, 2).reshape(-1, 6)
    want = tgrt.trace(*g, rays[:, :3], rays[:, 3:], kernel_degree=4,
                      min_transmittance=0.03, candidate_capacity=48)

    def image(x):
        return npy(tgut.tile_unpack(x.reshape(34, 256, -1).transpose(1, 2),
                                    grid))

    np.testing.assert_array_equal(npy(got["rgb"]), image(want.rgb))
    np.testing.assert_array_equal(npy(got["opacity"]),
                                  image(want.opacity[:, None])[..., 0])
    assert float(npy(got["opacity"]).max()) > 0.5


def test_secondary_splits_match_per_ray_trace(monkeypatch):
    """The engine's bundling of secondary rays (surface_groups; groups
    split by split_groups down to 1-ray groups, each filled with copies
    by fill_groups; the results scattered back) against a per-ray trace
    (grt.trace's exact ray route, each ray its own bundle) of the same
    rays: the rays off a mirror floor and a glass ball in a 32x32 frame
    (four tiles) through a cluster of particles, two bounces of
    Engine._trace_pass, with SPLIT_COUNT 8 so that groups are kept at the
    levels of 64, 16, 4 and 1 rays. The bundle route runs 64 re-sort
    passes, a full sort of every list here (at most 64 candidates), so
    that both composite in the exact per-ray order (the default 16 passes
    are B7's own approximation: a ray here takes two near hits in the
    other order). Radiance, opacity and depth within 1e-5 (the same f32
    sums in two codes)."""
    from threedgrut_torch.render import grt as tgrt
    from threedgrut_torch.render import gut as tgut
    rng = np.random.default_rng(7)
    n = 100
    quat = rng.normal(size=(n, 4))
    g = tuple(torch.tensor(x, dtype=torch.float32) for x in (
        rng.normal(size=(n, 3)) * 0.5 + [-0.8, -0.3, 3.5],
        quat / np.linalg.norm(quat, axis=-1, keepdims=True),
        np.exp(rng.normal(size=(n, 3)) * 0.3 - 2.0),
        rng.uniform(0.3, 0.9, n), rng.normal(size=(n, 16, 3)) * 0.3))
    mesh = tmesh.merge_meshes([
        tmesh.make_quad([0.0, 1.2, 3.0], [4.0, 0, 0], [0, 0, 4.0],
                        material_id=0, device="cpu"),
        tmesh.make_icosphere([0.2, 0.2, 3.0], 0.6, subdivisions=1,
                             material_id=1, device="cpu")])
    mats = tmat.make_materials(
        [dict(kind=tmat.MaterialKind.MIRROR, base_color=(0.9, 0.9, 0.9)),
         dict(kind=tmat.MaterialKind.GLASS, ior=1.4)], "cpu")
    eng = teng.Engine(*g, mesh=mesh, materials=mats,
                      config=teng.EngineConfig(max_bounces=2,
                                               candidate_capacity=n),
                      device="cpu")
    cam = PinholeCamera(torch.tensor([28.0, 28.0]),
                        torch.tensor([16.0, 16.0]), torch.zeros(6),
                        torch.zeros(2), torch.zeros(4))
    o, d = eng._camera_rays(cam, torch.eye(4), (32, 32))
    rays = tgut.tile_pack(torch.cat([o, d], -1).reshape(32, 32, 6),
                          (2, 2)).transpose(1, 2).reshape(-1, 6)
    o, d = rays[:, :3], rays[:, 3:]
    mh = tmesh.intersect(eng.mesh, o, d)
    nd, _, _, cont = tmat.bounce(
        eng.materials, mh.material_id, d, mh.normal,
        tenv.sample_envmap(None, mh.normal, default_color=(1.0, 1.0, 1.0)),
        uv=mh.uv, tangent=mh.tangent)
    live = (mh.material_id >= 0) & cont
    sec_o = o + d * torch.where(live, mh.t, 0.0)[:, None] + nd * 1e-4
    sec_d = torch.where(live[:, None], nd, torch.zeros_like(nd))
    assert set(mh.material_id[live].tolist()) == {0, 1}

    levels, most, fill, trace = [], [0], teng.fill_groups, tgrt.trace

    def fill_spy(src, keep):
        levels.append((src.shape[1], int(keep.sum())))
        return fill(src, keep)

    def trace_spy(*args, **kw):
        seg = trace(*args, sorted_passes=64, **kw)
        most[0] = max(most[0], int(seg.counts.max()))
        return seg

    def per_ray(o, d, live, t_max, surface=None):
        seg = trace(*g, o, torch.where(live[:, None], d, 0.0), order="ray",
                    bundle_size=1, kernel_degree=eng.cfg.kernel_degree,
                    min_transmittance=eng.cfg.min_transmittance,
                    candidate_capacity=n, t_max=t_max)
        return (seg.rgb, seg.opacity, seg.depth, seg.transmittance,
                seg.overflow)

    monkeypatch.setattr(teng, "fill_groups", fill_spy)
    monkeypatch.setattr(tgrt, "trace", trace_spy)
    monkeypatch.setattr(teng, "SPLIT_COUNT", 8)
    got = eng._trace_pass(sec_o, sec_d, mh.material_id)
    # The levels that kept rays: a level's own rays less the next's.
    kept = {size for (size, own), (nxt, own_nxt) in zip(
        levels, levels[1:] + [(256, 0)])
        if own > (own_nxt if nxt * 4 == size else 0)}
    assert kept == {64, 16, 4, 1} and most[0] <= 64
    monkeypatch.setattr(eng, "_trace_live", per_ray)
    want = eng._trace_pass(sec_o, sec_d, mh.material_id)
    assert not bool(got[3]) and not bool(want[3])
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(npy(a), npy(b), atol=1e-5)
    assert float(npy(want[1]).max()) > 0.5


def test_flat_cull_refuses_spread_origins():
    """The flat cull keeps the JAX package's rear bound (ROADMAP C17), so
    grt.trace refuses to be asked for both rather than drop
    spread_origins silently; either alone traces."""
    from threedgrut_torch.render import grt as tgrt
    g = tuple(t(np.asarray(x)) for x in random_scene(n=48, seed=2))
    rng = np.random.default_rng(3)
    o = torch.tensor(rng.normal(size=(256, 3)) * 0.01, dtype=torch.float32)
    d = torch.tensor(np.tile([[0.0, 0.0, 1.0]], (256, 1)),
                     dtype=torch.float32)
    with pytest.raises(ValueError, match="spread_origins"):
        tgrt.trace(*g, o, d, flat_cull=True, spread_origins=True)
    for kw in (dict(flat_cull=True), dict(spread_origins=True)):
        seg = tgrt.trace(*g, o, d, candidate_capacity=48, **kw)
        assert seg.counts.shape == (1,) and int(seg.counts[0]) > 0


def test_spread_origins_keep_particles_behind_the_mean_origin_c17():
    """ROADMAP C17: a bundle of rays from different origins (half from
    z = 0, half from z = 2, all along +z) and a particle at z = 0.5, in
    front of half the rays but 0.5 behind the bundle's mean origin. The
    JAX package's cone test drops it (its rear bound is the particle's
    radius); so does the port's by default (the same lists), and with
    spread_origins it keeps it, and the trace of those rays equals the
    per-ray trace (each ray its own bundle) within 1e-6."""
    from threedgrut_torch.render import grt as tgrt
    from threedgrut_tpu.render import grt as jgrt
    pos = np.array([[0, 0, 0.5], [0, 0, 2.5], [0, 0, 4.0]], np.float32)
    quat = np.tile(np.array([[1, 0, 0, 0]], np.float32), (3, 1))
    scale = np.full((3, 3), 0.05, np.float32)
    opa = np.full(3, 0.9, np.float32)
    feats = np.zeros((3, 16, 3), np.float32)
    feats[:, 0] = [[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]]
    rng = np.random.default_rng(0)
    o = np.zeros((256, 3), np.float32)
    o[:, :2] = rng.uniform(-0.01, 0.01, (256, 2))
    o[128:, 2] = 2.0
    d = np.tile(np.array([[0, 0, 1.0]], np.float32), (256, 1))
    radius = np.asarray(jgrt.bounding_radius(jnp.asarray(scale),
                                             jnp.asarray(opa), 4))
    valid = opa >= 1.0 / 255.0
    jres = jgrt.bundle_candidates(
        jnp.asarray(pos), jnp.asarray(radius), jnp.asarray(valid),
        jgrt.make_bundles(jnp.asarray(o), jnp.asarray(d), 256), 4)
    want = sorted(np.asarray(jres[0])[0, :int(jres[1][0])].tolist())
    assert want == [1, 2]                        # JAX drops particle 0
    for spread, ids in ((False, [1, 2]), (True, [0, 1, 2])):
        res = tgrt.bundle_candidates(
            t(pos), t(radius), t(valid),
            tgrt.make_bundles(t(o), t(d), 256, spread), 4)
        assert sorted(npy(res[0])[0, :int(res[1][0])].tolist()) == ids
    g = tuple(t(x) for x in (pos, quat, scale, opa, feats))
    kw = dict(kernel_degree=4, min_transmittance=0.03, candidate_capacity=4)
    exact = tgrt.trace(*g, t(o), t(d), order="ray", bundle_size=1, **kw)
    got = tgrt.trace(*g, t(o), t(d), spread_origins=True, **kw)
    plain = tgrt.trace(*g, t(o), t(d), **kw)
    np.testing.assert_allclose(npy(got.rgb), npy(exact.rgb), atol=1e-6)
    np.testing.assert_allclose(npy(got.transmittance),
                               npy(exact.transmittance), atol=1e-6)
    # The dropped hit: the red particle in front of the rays from z = 0.
    assert (npy(exact.rgb)[:128, 0] > npy(plain.rgb)[:128, 0] + 0.2).all()
