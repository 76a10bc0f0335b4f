"""Multi-device training over a (data, tile, model) mesh of processes, port
of threedgrut_tpu/parallel/dp.py on torch.distributed.

One process per rank, PyTorch's idiom (the JAX package has one process
drive every device). Rank r sits at (d, t, m) = (r // (T M), (r // M) % T,
r % M), the row-major order of the JAX package's reshape(n // (T M), T, M):

  * "data": the views of a step, one per data row (a step takes B = D
    views);
  * "tile": a view's 16x16 pixel tiles, split into T strips;
  * "model": the particles, split into M shards for projection, SH colours
    and packing, gathered before the binning and sort (which run on the
    whole set on every rank) and the strip's compositing (B1, B2).

Parameters and Adam state are replicated: every rank holds them whole and
ends each step with the same bits, because every reduction here gives the
same result on every rank (`all_gather` and `ordered_sum`).

Gathers. Every collective is an int32 all_reduce of a zero-filled buffer
into which each rank writes the bits of its own slice: the one primitive
NCCL and gloo both carry for CUDA tensors (gloo's table lists broadcast and
all_reduce only; torch.distributed.nn's all_gather backward needs
all_to_all). Adding 0 to an int32 is exact, so the slices come back bit for
bit, -0.0 and NaN payloads included. The loss is computed identically on
every rank of a (tile, model) group, so the cotangent of a gathered tensor
is the same on every rank of its group: the gather's backward keeps this
rank's slice and communicates nothing (the JAX package divides the loss by
B T M instead and sums the gathers' transposes; the gradients are the
same).

Reductions (RankShard.reduce, before Adam): each row's gradients are
gathered over the row's T M ranks and summed in rank order, giving that
view's gradient at the single-device step's scale; those are gathered over
the data axis and summed in row order, then divided by B: the mean over the
views, the JAX package's step gradient. Visibility is ORed over the views
(the trainer ands it with the nonzero gradients), the overflow flag ORed,
the loss terms and PSNR averaged. Each view's position-gradient norm and
hit visibility come with them, for a densification that accumulates per
view (ROADMAP C18).

The data-parallel step is the single-device step (trainer.step_fn) with a
RankShard: every option that honours (sorted passes, row termination, ray
jitter, masks, the rolling shutter's end pose) holds on the mesh as well.
The JAX package's step runs its own 3DGUT render whatever the
configuration says (ROADMAP C19); here a 3DGRT configuration is refused
(`check_supported`) before any process group starts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from threedgrut_torch import optimizers
from threedgrut_torch.ops.projection import Projection

AXES = ("data", "tile", "model")
# The process groups of a rank: one per axis, and its data row (the T M
# ranks of its view).
GROUPS = AXES + ("row",)


def coords_of(rank: int, shape: Tuple[int, int, int]) -> Tuple[int, ...]:
    """(d, t, m) of a rank in a (D, T, M) mesh."""
    _, T, M = shape
    return (rank // (T * M), (rank // M) % T, rank % M)


def _group_members(shape: Tuple[int, int, int], name: str):
    """Every group of `name` in a fixed order, each as its ranks in rank
    order."""
    D, T, M = shape
    vary = {"data": (0,), "tile": (1,), "model": (2,), "row": (1, 2)}[name]
    groups: Dict[tuple, List[int]] = {}
    for r in range(D * T * M):
        c = coords_of(r, shape)
        key = tuple(x for i, x in enumerate(c) if i not in vary)
        groups.setdefault(key, []).append(r)
    return [groups[k] for k in sorted(groups)]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's place in a (data, tile, model) mesh: the shape, its global
    rank and its process groups (None where the mesh is one process with
    no process group: every collective is then the identity)."""
    shape: Tuple[int, int, int]
    rank: int
    groups: Dict[str, object]

    @property
    def coords(self) -> Tuple[int, ...]:
        return coords_of(self.rank, self.shape)

    @property
    def size(self) -> int:
        D, T, M = self.shape
        return D * T * M

    def axis(self, name: str) -> Tuple[int, int]:
        """(size, this rank's index) along "data", "tile", "model" or "row"
        (the row's ranks in rank order)."""
        D, T, M = self.shape
        d, t, m = self.coords
        return {"data": (D, d), "tile": (T, t), "model": (M, m),
                "row": (T * M, t * M + m)}[name]


def make_mesh(data: int = 1, tile: int = 1, model: int = 1) -> Mesh:
    """This process's rank in a (data, tile, model) mesh over the
    initialized default process group (parallel/multihost.initialize), and
    the process groups of its axes. Every rank must call it with the same
    shape (torch.distributed.new_group is collective). The world size must
    be data x tile x model; a mesh of one process needs no process group."""
    shape = (int(data), int(tile), int(model))
    if min(shape) < 1:
        raise ValueError(f"mesh {shape}: every axis needs at least 1")
    n = shape[0] * shape[1] * shape[2]
    if not (dist.is_available() and dist.is_initialized()):
        if n != 1:
            raise ValueError(f"mesh {shape} needs {n} processes, and no "
                             f"process group is initialized "
                             f"(parallel/multihost.initialize)")
        return Mesh(shape, 0, {g: None for g in GROUPS})
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {shape} needs a world of {n} processes; "
                         f"this one has {world}")
    rank = dist.get_rank()
    groups = {}
    for name in GROUPS:
        for members in _group_members(shape, name):
            g = dist.new_group(members)
            if rank in members:
                groups[name] = g
    return Mesh(shape, rank, groups)


def check_supported(cfg, shape) -> None:
    """Refuse what the mesh's step cannot train: its render is the 3DGUT
    rasterizer's (gut.render with a RankShard). The JAX package's mesh step
    trains the rasterizer whatever render.method says (ROADMAP C19)."""
    if cfg.render.method != "3dgut":
        raise ValueError(
            f"render.method={cfg.render.method!r} on the (data, tile, "
            f"model) mesh {tuple(shape)}: the mesh's train step renders "
            f"with the 3DGUT rasterizer only (render.method='3dgut'); train "
            f"3DGRT on one device")


# ---- the gathers -----------------------------------------------------------

def _words(x: torch.Tensor) -> torch.Tensor:
    """x's bits as a flat int32 tensor (bool and narrow integers widened)."""
    flat = x.detach().contiguous().reshape(-1)
    if flat.dtype != torch.bool and flat.element_size() in (4, 8):
        return flat.view(torch.int32)
    return flat.to(torch.int32)


def _unwords(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[size, k] int32 words -> [size, *like.shape] of like's dtype."""
    if like.dtype == torch.bool:
        x = w != 0
    elif like.element_size() == 4:
        x = w.contiguous().view(like.dtype)
    elif like.element_size() == 8:
        # A fresh copy: viewing pairs of words needs even offsets.
        x = w.reshape(-1).clone().reshape(w.shape).view(like.dtype)
    else:
        x = w.to(like.dtype)
    return x.reshape((w.shape[0],) + tuple(like.shape))


def all_gather(tensors: Sequence[torch.Tensor], group, size: int,
               index: int) -> List[torch.Tensor]:
    """Every rank's `tensors` ([size, *shape] each, in the group's rank
    order) through one int32 all_reduce of a zero-filled buffer in which
    this rank (`index` in the group of `size`) writes its tensors' bits.
    The result is the same bits on every rank of the group. `group` None:
    one process (size 1), no communication."""
    words = [_words(x) for x in tensors]
    lens = [w.numel() for w in words]
    buf = torch.zeros((size, sum(lens)), dtype=torch.int32,
                      device=tensors[0].device)
    buf[index] = torch.cat(words)
    if group is not None:
        dist.all_reduce(buf, group=group)
    elif size != 1:
        raise ValueError(f"a gather over {size} ranks needs a process group")
    out, off = [], 0
    for x, k in zip(tensors, lens):
        out.append(_unwords(buf[:, off:off + k], x))
        off += k
    return out


def ordered_sum(stacked: torch.Tensor) -> torch.Tensor:
    """stacked[0] + stacked[1] + ... in that order (stacked[0]'s bits for
    one): the same result on every rank that holds the same stack."""
    acc = stacked[0].clone()
    for x in stacked[1:]:
        acc += x
    return acc


class _GatherSlices(torch.autograd.Function):
    """Concatenate the group's slices along axis 0. The backward keeps this
    rank's slice of the cotangent: the loss is computed identically on
    every rank of the group, so that cotangent is the same on each."""

    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.rows, ctx.index = x.shape[0], index
        (full,) = all_gather([x], group, size, index)
        return full.reshape((size * x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None, None, None


def gather_slices(x: torch.Tensor, group, size: int,
                  index: int) -> torch.Tensor:
    """The group's slices of x concatenated along axis 0, differentiable
    (the backward is local)."""
    return _GatherSlices.apply(x, group, size, index)


# ---- a rank's part of the step ---------------------------------------------

class RankShard:
    """The hooks of one mesh rank's train step, given to trainer.step_fn
    (and through it to gut.render): the rank's particle shard and tile
    strip, their gathers, and the reductions before Adam."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    @property
    def batch(self) -> int:
        return self.mesh.shape[0]

    def check_step(self, cfg, train: bool) -> None:
        if not train:
            raise ValueError("a mesh rank's step is a train step; evaluate "
                             "on one device (Trainer.eval_view)")
        check_supported(cfg, self.mesh.shape)

    def local_particles(self, xs):
        """This rank's contiguous shard of each [N, ...] tensor of xs."""
        M, m = self.mesh.axis("model")
        if M == 1:
            return xs
        n = xs[0].shape[0]
        if n % M:
            raise ValueError(f"the capacity {n} does not divide by the "
                             f"model axis {M} of the mesh "
                             f"{self.mesh.shape}")
        k = n // M
        return tuple(x[m * k:(m + 1) * k] for x in xs)

    def gather_projection(self, proj: Projection) -> Projection:
        M, m = self.mesh.axis("model")
        if M == 1:
            return proj
        full = all_gather(list(proj), self.mesh.groups["model"], M, m)
        return Projection(*(x.reshape((-1,) + tuple(x.shape[2:]))
                            for x in full))

    def gather_particles(self, x: torch.Tensor) -> torch.Tensor:
        M, m = self.mesh.axis("model")
        if M == 1:
            return x
        return gather_slices(x, self.mesh.groups["model"], M, m)

    def local_tiles(self, num_tiles: int) -> Optional[slice]:
        """This rank's strip of the tiles (None: all of them)."""
        T, t = self.mesh.axis("tile")
        if T == 1:
            return None
        if num_tiles % T:
            raise ValueError(f"{num_tiles} tiles do not divide by the tile "
                             f"axis {T} of the mesh {self.mesh.shape}")
        k = num_tiles // T
        return slice(t * k, (t + 1) * k)

    def gather_tiles(self, out: torch.Tensor) -> torch.Tensor:
        T, t = self.mesh.axis("tile")
        if T == 1:
            return out
        return gather_slices(out, self.mesh.groups["tile"], T, t)

    def reduce(self, grads: Dict[str, torch.Tensor], cone_vis, overflow,
               terms: Dict[str, torch.Tensor], psnr):
        """The step's reductions (the module docstring). Returns (the mean
        gradients, the cone visibility ORed over the views, the overflow
        flag ORed, the mean terms, the mean PSNR, {"view_pos_grad_norm":
        [B, N] each view's position-gradient norm, "view_visibility": [B,
        N] each view's cone visibility and nonzero gradient}), the same
        bits on every rank."""
        fields = optimizers.PARAM_FIELDS
        shapes = [grads[f].shape for f in fields]
        flat = torch.cat([grads[f].reshape(-1) for f in fields])
        R, r = self.mesh.axis("row")
        (rows,) = all_gather([flat], self.mesh.groups["row"], R, r)
        view_grad = ordered_sum(rows)
        names = sorted(terms)
        scalars = torch.stack([terms[k].to(torch.float32) for k in names]
                              + [psnr.to(torch.float32)])
        B, d = self.mesh.axis("data")
        views, vis, ovf, sc = all_gather(
            [view_grad, cone_vis, overflow, scalars],
            self.mesh.groups["data"], B, d)
        total, means = ordered_sum(views), ordered_sum(sc)
        if B > 1:
            total /= B
            means /= B
        out, view_hit, off = {}, torch.zeros_like(vis), 0
        n = cone_vis.shape[0]
        for f, shape in zip(fields, shapes):
            k = shape.numel()
            out[f] = total[off:off + k].reshape(shape)
            view_hit |= (views[:, off:off + k].reshape(B, n, -1)
                         != 0.0).any(-1)
            off += k
        pos = fields.index("positions")
        lo = sum(s.numel() for s in shapes[:pos])
        view_norm = torch.linalg.norm(
            views[:, lo:lo + shapes[pos].numel()].reshape(B, n, 3), dim=-1)
        extra = dict(view_pos_grad_norm=view_norm,
                     view_visibility=vis & view_hit)
        mean_terms = {k: means[i] for i, k in enumerate(names)}
        return (out, vis.any(0), ovf.any(), mean_terms, means[-1], extra)


# ---- placement --------------------------------------------------------------

@torch.no_grad()
def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Broadcast each tensor in place from rank 0 of the mesh, so that every
    rank starts from rank 0's bits."""
    if mesh.groups["data"] is None:
        return
    for x in tensors:
        dist.broadcast(x, src=0)


def shard_batch(views: Sequence, mesh: Mesh):
    """This rank's view of a step's B views (its data row's)."""
    D, d = mesh.axis("data")
    if len(views) != D:
        raise ValueError(f"a step of the mesh {mesh.shape} takes {D} views, "
                         f"got {len(views)}")
    return views[d]
