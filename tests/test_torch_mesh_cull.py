"""M1's cull (threedgrut_torch/ops/mesh_intersect.py): the faces that a
block of consecutive rays keeps (`block_face_masks_plain`, the interval
evaluation of the pair test over the block's boxes of origins and
directions that csrc/mesh_intersect.cu runs) hold every face that a live
ray of the block hits, and the exact test over them
(`closest_hits_culled_plain`) equals the brute force (`closest_hits_plain`)
bit for bit. One scene shape: tests/test_torch_playground.py's props (a
glass icosphere of subdivision 2 and a quad behind it, 322 faces), under
ray families that the engine hands M1 (tile-ordered camera rays, rays
reflected off a floor, rays leaving the sphere, inactive rays in and as
whole blocks, a partial last block) and random rays, and edge cases (rays
through shared edges and vertices, grazing rays with |a| near 1e-9, hits
near t_min, coordinates near 1e4, non-finite rays); a hypothesis property
over random boxes and faces; exact ties; the culled path against JAX's
intersect. No tolerance: masks are checked for inclusion and outputs for
equal bits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_grt import single_thread  # noqa: F401 (autouse)
from tests.test_torch_playground import npy, port_mesh, props, rays
from threedgrut_torch.ops import mesh_intersect as mi
from threedgrut_tpu.playground import mesh as jmesh

EYE = np.array([0.0, 0.0, -0.5], np.float32)
CENTRE, RADIUS = np.array([0.1, -0.2, 3.0], np.float32), 0.8
FLOOR_Y = -1.05
BLOCKS = (32, mi.BLOCK)


def scene():
    """(props mesh on the CPU, its [F, 9] faces)."""
    m = port_mesh(props())
    return m, mi.triangles(m.vertices, m.faces)


def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def tile_order(x, side):
    """[side * side, 3] pixel rows -> 16x16 tiles, each 256 consecutive."""
    n = side // 16
    return x.reshape(n, 16, n, 16, 3).transpose(0, 2, 1, 3, 4).reshape(-1, 3)


def camera(side=64, eye=EYE):
    """Pinhole rays from `eye` down +z (fov ~52 degrees), tile order."""
    px = (np.arange(side) + 0.5 - side / 2) / (side / 2 / np.tan(0.45))
    x, y = np.meshgrid(px, px, indexing="xy")
    d = unit(np.stack([x, y, np.ones_like(x)], -1).reshape(-1, 3))
    d = tile_order(d, side)
    return np.broadcast_to(eye, d.shape).astype(np.float32), d


def reflected(side=64):
    """Camera rays mirrored off the floor y = FLOOR_Y toward the props:
    origins spread over the floor; rays that miss the floor inactive (the
    upper tiles: whole blocks of zero directions)."""
    o, d = camera(side)
    down = d[:, 1] < -1e-3
    t_floor = np.where(down, (FLOOR_Y - o[:, 1]) / np.where(down, d[:, 1],
                                                            1.0), 0.0)
    o = (o + d * t_floor[:, None]).astype(np.float32)
    d = d * np.array([1.0, -1.0, 1.0], np.float32)
    d[~down] = 0.0
    return o, d


def leaving_sphere(side=64):
    """Camera rays that cross the true sphere leave it at its far side,
    bent 0.3 toward the outward normal; the rest inactive."""
    o, d = camera(side)
    oc = o - CENTRE
    b = (oc * d).sum(-1)
    disc = b * b - ((oc * oc).sum(-1) - RADIUS ** 2)
    hit = disc > 0
    t_far = -b + np.sqrt(np.maximum(disc, 0.0))
    p = o + d * (0.999 * t_far)[:, None]
    out = unit(p - CENTRE)
    nd = unit(d + 0.3 * out)
    return (np.where(hit[:, None], p, o).astype(np.float32),
            np.where(hit[:, None], nd, 0.0).astype(np.float32))


def random_rays(n=1000, seed=0):
    """Incoherent rays; 1000 = 3 blocks of 256 and a partial one."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 2, (n, 3)).astype(np.float32) + CENTRE
    return o, unit(rng.normal(size=(n, 3)))


def with_inactive():
    """Camera rays with every third ray, then one whole block, inactive,
    and a partial last block of 100."""
    o, d = camera()
    d = d.copy()
    d[::3] = 0.0
    d[512:768] = 0.0
    return o[:868].copy(), d[:868].copy()


def edges_and_vertices(tri):
    """From the eye through every vertex and edge midpoint of the faces."""
    tri = npy(tri)
    p0, p1, p2 = tri[:, :3], tri[:, :3] + tri[:, 3:6], tri[:, :3] + tri[:, 6:]
    pts = np.concatenate([p0, p1, p2, (p0 + p1) / 2, (p1 + p2) / 2,
                          (p0 + p2) / 2])
    pts = np.unique(pts, axis=0)
    return np.broadcast_to(EYE, pts.shape).astype(np.float32), unit(pts - EYE)


def grazing(tri):
    """Rays through face centroids at angles tau to the face's plane, from
    0 to 1e-4 rad: a = e1 . (d x e2) runs through 1e-9 (both signs)."""
    tri = npy(tri).astype(np.float64)
    sel = np.r_[0:2, 2:322:20]
    taus = np.r_[0.0, np.geomspace(1e-11, 1e-4, 22)]
    o, d = [], []
    for f in sel:
        e1, e2 = tri[f, 3:6], tri[f, 6:]
        n = np.cross(e1, e2)
        n /= np.linalg.norm(n)
        x = tri[f, :3] + (e1 + e2) / 3
        for s in (1.0, -1.0):
            for tau in taus:
                dd = e1 / np.linalg.norm(e1) + s * tau * n
                dd /= np.linalg.norm(dd)
                d.append(dd)
                o.append(x - 2.0 * dd)
    return np.array(o, np.float32), np.array(d, np.float32)


def near_t_min(tri):
    """Origins at distances around t_min = 1e-4 before face centroids (and
    on the faces)."""
    tri = npy(tri)
    x = tri[::7, :3] + (tri[::7, 3:6] + tri[::7, 6:]) / 3
    d = unit(x - EYE)
    tt = np.array([0.0, 5e-5, 9.9e-5, 1e-4, 1.01e-4, 2e-4, 1e-3],
                  np.float32)
    o = (x[:, None] - d[:, None] * tt[None, :, None]).reshape(-1, 3)
    return o.astype(np.float32), np.repeat(d, len(tt), 0)


def non_finite():
    """Camera rays with NaN and inf in a few origins and directions (their
    blocks keep every face), and an inactive ray with a NaN origin."""
    o, d = camera()
    o, d = o.copy(), d.copy()
    o[5] = np.nan
    d[300, 0] = np.inf
    o[600, 2] = -np.inf
    o[900], d[900] = np.nan, 0.0
    return o, d


FAR = np.array([1e4, -1e4, 1e4], np.float32)


def case(name):
    """(o, d, tri) of one ray family on the props."""
    _, tri = scene()
    if name == "camera":
        o, d = camera()
    elif name == "reflected":
        o, d = reflected()
    elif name == "leaving_sphere":
        o, d = leaving_sphere()
    elif name == "random":
        o, d = random_rays()
    elif name == "inactive":
        o, d = with_inactive()
    elif name == "edges_and_vertices":
        o, d = edges_and_vertices(tri)
    elif name == "grazing":
        o, d = grazing(tri)
    elif name == "near_t_min":
        o, d = near_t_min(tri)
    elif name == "far":
        # The props and the eye moved by 1e4 in each coordinate.
        m = port_mesh(props())
        tri = mi.triangles(m.vertices + torch.tensor(FAR), m.faces)
        o, d = camera(eye=EYE + FAR)
    else:
        o, d = non_finite()
    return torch.tensor(o), torch.tensor(d), tri


CASES = ("camera", "reflected", "leaving_sphere", "random", "inactive",
         "edges_and_vertices", "grazing", "near_t_min", "far", "non_finite")


def hit_faces(o, d, tri, block):
    """[blocks, F] bool: some ray of the block passes the pair test with
    the face (the brute force's test, without the running best)."""
    t, _, _ = mi._pair_test(o, d, tri, 1e-4)
    r = o.shape[0]
    hit = torch.nn.functional.pad(torch.isfinite(t), (0, 0, 0, -r % block))
    return hit.reshape(-1, block, tri.shape[0]).any(1)


def assert_culled_equal(o, d, tri, block):
    want = mi.closest_hits_plain(o, d, tri)
    got = mi.closest_hits_culled_plain(o, d, tri, block=block)
    for name, g, w in zip(("t", "face", "u", "w"), got, want):
        assert torch.equal(g, w), name
    return want


@pytest.mark.parametrize("name", CASES)
def test_cull_keeps_every_hit_face_and_culled_hits_are_bit_equal(name):
    o, d, tri = case(name)
    for block in BLOCKS:
        masks = mi.block_face_masks_plain(o, d, tri, block=block)
        hits = hit_faces(o, d, tri, block)
        assert masks.shape == hits.shape
        missed = hits & ~masks
        assert not bool(missed.any()), (block, torch.nonzero(missed)[:5])
        want = assert_culled_equal(o, d, tri, block)
    assert int(torch.isfinite(want[0]).sum()) > 0, name


def test_blocks_without_live_rays_keep_nothing_and_bad_rays_keep_all():
    """An all-inactive block keeps no face; a block with a live non-finite
    ray keeps every face; the partial last block has its own row."""
    o, d, tri = case("inactive")
    masks = mi.block_face_masks_plain(o, d, tri)
    assert masks.shape == (4, tri.shape[0])
    assert not bool(masks[2].any())
    assert bool(masks[3].any())
    o, d, tri = case("non_finite")
    masks = mi.block_face_masks_plain(o, d, tri)
    assert bool(masks[0].all()) and bool(masks[1].all()) \
        and bool(masks[2].all())
    assert not bool(masks[3].all())         # the inactive NaN ray's block
    o0 = torch.zeros((0, 3))
    assert mi.block_face_masks_plain(o0, o0, tri).shape == (0, tri.shape[0])
    assert mi.block_face_masks_plain(o, d, tri[:0]).shape == (16, 0)


@pytest.mark.parametrize("name", ("camera", "inactive", "non_finite"))
def test_cull_work_counts_culling_blocks_and_faces_past_the_a_tests(name):
    """block_cull_plain's work counts, which chip_smoke.py's bound reads:
    a block culls where it has a live ray and no live non-finite one; with
    blocks of one ray the interval of a is the ray's own a, so the faces
    past the a tests are those with |a| > 1e-9 (a = e1 . (d x e2) in the
    pair test's order); the masks are block_face_masks_plain's."""
    o, d, tri = case(name)
    live = (d != 0).any(-1)
    finite = torch.isfinite(o).all(-1) & torch.isfinite(d).all(-1)
    for block in (1, mi.BLOCK):
        masks, culled, full = mi.block_cull_plain(o, d, tri, block=block)
        assert torch.equal(masks, mi.block_face_masks_plain(
            o, d, tri, block=block))
        pad = -o.shape[0] % block
        lv = torch.nn.functional.pad(live, (0, pad)).reshape(-1, block)
        bad = torch.nn.functional.pad(live & ~finite, (0, pad)).reshape(
            -1, block)
        assert torch.equal(culled, lv.any(1) & ~bad.any(1)), block
        assert not bool(full[~culled].any())
        assert bool((full <= tri.shape[0]).all())
    d0, d1, d2 = (d[:, k:k + 1] for k in range(3))
    a0, a1, a2, b0, b1, b2 = (tri[None, :, k] for k in range(3, 9))
    a = (a0 * (d1 * b2 - d2 * b1) + a1 * (d2 * b0 - d0 * b2)
         + a2 * (d0 * b1 - d1 * b0))
    want = ((torch.abs(a) > 1e-9) & (live & finite)[:, None]).sum(1)
    assert torch.equal(mi.block_cull_plain(o, d, tri, block=1)[2], want)
    assert int(want.sum()) > 0, name


def test_cull_drops_most_faces_of_coherent_blocks():
    """The cull has teeth: at 256x256 (a tile ~3.4 degrees wide), a tile of
    camera rays keeps under a tenth of the 322 faces (those over its
    frustum and their neighbours), one of rays off the floor or leaving
    the sphere under a quarter; each keeps the faces its rays hit."""
    shares = {}
    for fn in (camera, reflected, leaving_sphere):
        o, d = (torch.tensor(x) for x in fn(256))
        _, tri = scene()
        masks = mi.block_face_masks_plain(o, d, tri)
        live = (d != 0).any(-1).reshape(-1, mi.BLOCK).any(1)
        assert not bool((hit_faces(o, d, tri, mi.BLOCK) & ~masks).any())
        shares[fn.__name__] = float(masks[live].float().mean())
    assert shares["camera"] < 0.1, shares
    assert shares["reflected"] < 0.25 and shares["leaving_sphere"] < 0.25, \
        shares


def test_exact_ties_take_the_lowest_face():
    """Rays through the shared diagonal of a quad with integer corners and
    a face duplicated at a higher index: the cull keeps both faces of each
    tie and the culled path takes the lowest index, as the brute force."""
    v = torch.tensor([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]],
                     dtype=torch.float32)
    f = torch.tensor([[0, 1, 2], [0, 2, 3], [3, 2, 0], [0, 1, 2]],
                     dtype=torch.int32)
    tri = mi.triangles(v, f)
    xs = torch.tensor([-0.5, -0.25, 0.0, 0.25, 0.5, 0.75])
    o = torch.cat([torch.stack([xs, xs, torch.zeros_like(xs)], -1),
                   torch.tensor([[0.5, -0.5, 0.0], [-0.5, 0.5, 0.0]])])
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(len(o), 3).contiguous()
    for block in (1, 4, mi.BLOCK):
        masks = mi.block_face_masks_plain(o, d, tri, block=block)
        assert not bool((hit_faces(o, d, tri, block) & ~masks).any()), block
        want = assert_culled_equal(o, d, tri, block)
    assert want[1].tolist() == [0] * 6 + [0, 1]


def test_culled_path_matches_jax_intersect():
    """Faces and materials of the culled path equal JAX's intersect on the
    props (its random rays and rays from inside the sphere)."""
    jm = props()
    m = port_mesh(jm)
    tri = mi.triangles(m.vertices, m.faces)
    o, d = rays(509, 3)
    inside = np.tile(CENTRE[None], (64, 1))
    for oo, dd in ((o, d), (inside, d[:64])):
        want = jmesh.intersect(jm, jnp.asarray(oo), jnp.asarray(dd))
        _, face, _, _ = mi.closest_hits_culled_plain(
            torch.tensor(oo), torch.tensor(dd), tri)
        mat = torch.where(face >= 0, m.material_id[face.clamp(min=0).long()],
                          -1)
        np.testing.assert_array_equal(npy(face), np.asarray(want.face))
        np.testing.assert_array_equal(npy(mat), np.asarray(want.material_id))
    assert (npy(face) >= 0).sum() > 10


coord = st.floats(-4.0, 4.0, allow_nan=False, width=32)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(verts=st.lists(coord, min_size=9, max_size=9),
       origin=st.lists(coord, min_size=3, max_size=3),
       o_half=st.floats(0.0, 1.0, width=32),
       d_half=st.floats(0.0, 0.25, width=32),
       bary=st.tuples(st.floats(-0.2, 1.2), st.floats(-0.2, 1.2)),
       scale=st.sampled_from([1e-3, 1.0, 1e3]),
       seed=st.integers(0, 2 ** 16))
def test_cull_property_random_boxes_and_faces(verts, origin, o_half, d_half,
                                              bary, scale, seed):
    """A face and a block of 64 rays whose origins fill a box and whose
    directions, aimed near a point of the face's plane, fill another (the
    boxes' corners among them): if any ray hits the face, the block keeps
    it, and the culled path equals the brute force."""
    rng = np.random.default_rng(seed)
    p = np.array(verts, np.float32).reshape(3, 3) * scale
    target = p[0] + bary[0] * (p[1] - p[0]) + bary[1] * (p[2] - p[0])
    c = np.array(origin, np.float32) * scale
    dc = unit(target - c + 1e-3 * scale)
    corners = np.array(np.meshgrid([-1, 1], [-1, 1], [-1, 1])).reshape(3, -1).T
    so = np.concatenate([corners, rng.uniform(-1, 1, (56, 3))])
    sd = np.concatenate([corners[::-1], rng.uniform(-1, 1, (56, 3))])
    o = (c + o_half * scale * so).astype(np.float32)
    d = (dc + d_half * sd).astype(np.float32)
    tri = mi.triangles(torch.tensor(p), torch.tensor([[0, 1, 2]],
                                                     dtype=torch.int32))
    o, d = torch.tensor(o), torch.tensor(d)
    mask = mi.block_face_masks_plain(o, d, tri, block=64)
    if bool(hit_faces(o, d, tri, 64).any()):
        assert bool(mask.all())
    assert_culled_equal(o, d, tri, 64)
