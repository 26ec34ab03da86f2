"""Spatial sharding: the volume's z (D) axis split over the mesh's
``space`` axis (the counterpart of unet_studio_tpu/parallel/spatial.py).

Each rank holds one D-slab ``(N, D/n, H, W, C)`` and runs the plain layers
(``models/unet3d.py`` ``forward(slab=...)``), as the JAX package runs this
path on XLA's convolutions, not on its Pallas kernels.  Where GSPMD
inserts the communication there, it is explicit here:

* halo exchange (``_Halo``): before each 3^3 conv the slab takes the
  planes it reads from its z neighbours (zeros at the volume's ends);
  the backward returns their gradients to the rank that owns them.  A
  stride-1 conv reads one plane each side, a stride-2 conv one plane
  below only (the slab starts on an even plane); ks2/s2 transposed
  convs, max pooling, upsampling and ks1 convs read none.
* instance norm over the whole volume: the slabs' sums of x, then of
  (x - mean)^2, are added over the slabs before the mean and the
  variance (``_SlabSum``, two passes as on one card).
* the deep-supervision loss from global sums: CE, MSE and the dice terms
  (``_ReplicatedSum``).

Every rank then holds the same loss.  Its sums enter it once, so their
backward passes the cotangent through; the norms' sums are read by each
slab with its own data, so their backward adds the slabs' cotangents.
After one sum over the ranks, the gradients of the replicated parameters
equal the unsharded step's.

D must be divisible by 2^(levels-1) * n_space, as in the JAX package.
With gloo the halos go through host tensors (gloo's send and receive take
CPU tensors); with NCCL they stay on the card.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..engine.optimizer import SGDConfig, sgd_step
from ..models.unet3d import UNet3d, forward
from ..ops.losses import deep_supervision_loss
from .mesh import Mesh, all_reduce_sum


def spatial_sharding(mesh: Mesh, depth: int) -> slice:
    """This rank's planes of a volume of ``depth`` planes: the counterpart
    of the JAX package's ``P(None, "space")`` on (N, D, H, W, C)."""
    if depth % mesh.n_space:
        raise ValueError(f"D={depth} does not split over {mesh.n_space} space ranks")
    per = depth // mesh.n_space
    lo = mesh.space_index * per
    return slice(lo, lo + per)


class _Slab:
    """This rank's z-slab: its neighbours on the space axis, the halo
    exchange and the sums over the slabs (``n`` slabs)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = mesh.n_space
        s = mesh.space_index
        # the space axis is the minor axis: neighbours are adjacent ranks
        self.below = mesh.rank - 1 if s > 0 else None
        self.above = mesh.rank + 1 if s < self.n - 1 else None
        self.via_host = self.n > 1 and dist.get_backend() == "gloo"

    def halo(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        """(N, C, D, H, W) -> (N, C, lo + D + hi, H, W): ``lo`` planes from
        the slab below and ``hi`` from the slab above in front of and
        behind this one."""
        if max(lo, hi) > x.shape[2]:
            raise ValueError(f"a halo of {max(lo, hi)} planes around a slab of {x.shape[2]}")
        return _Halo.apply(x, self, lo, hi)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return _SlabSum.apply(t, self) if self.n > 1 else t

    def psum_replicated(self, t: torch.Tensor) -> torch.Tensor:
        return _ReplicatedSum.apply(t, self) if self.n > 1 else t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        out = t.clone()
        dist.all_reduce(out, group=self.mesh.space_group)
        return out

    def exchange(self, to_below, to_above, n_below: int, n_above: int, like):
        """Send ``to_below`` to the slab below and ``to_above`` to the slab
        above; receive ``n_below`` planes from below and ``n_above`` from
        above (zeros where there is no neighbour).  Each pair of
        neighbours swaps at most one message each way."""
        comm = torch.device("cpu") if self.via_host else like.device

        def planes(k):
            shape = list(like.shape)
            shape[2] = k
            return torch.zeros(shape, dtype=like.dtype, device=comm)

        from_below, from_above = planes(n_below), planes(n_above)
        ops = []
        for peer, send, recv in ((self.below, to_below, from_below),
                                 (self.above, to_above, from_above)):
            if peer is None:
                continue
            if send.numel():
                ops.append(dist.P2POp(dist.isend, send.contiguous().to(comm), peer))
            if recv.numel():
                ops.append(dist.P2POp(dist.irecv, recv, peer))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_below.to(like.device), from_above.to(like.device)


class _Halo(torch.autograd.Function):
    """Pad a slab with its neighbours' planes; the backward adds the
    halo's gradient into the planes of the rank that owns them."""

    @staticmethod
    def forward(ctx, x, slab: _Slab, lo: int, hi: int):
        ctx.slab, ctx.lo, ctx.hi = slab, lo, hi
        d = x.shape[2]
        # my first hi planes are the upper halo of the slab below, my last
        # lo planes the lower halo of the slab above
        below, above = slab.exchange(x[:, :, :hi], x[:, :, d - lo:], lo, hi, x)
        return torch.cat([below, x, above], dim=2)

    @staticmethod
    def backward(ctx, g):
        slab, lo, hi = ctx.slab, ctx.lo, ctx.hi
        d = g.shape[2] - lo - hi
        gx = g[:, :, lo:lo + d].clone()
        from_below, from_above = slab.exchange(g[:, :, :lo], g[:, :, lo + d:], hi, lo, g)
        gx[:, :, :hi] += from_below
        gx[:, :, d - lo:] += from_above
        return gx, None, None, None


class _SlabSum(torch.autograd.Function):
    """Sum over the slabs of a value each slab then reads with its own
    data (the norms' statistics): the backward sums the slabs'
    cotangents, each slab's share of the total's gradient."""

    @staticmethod
    def forward(ctx, t, slab: _Slab):
        ctx.slab = slab
        return slab.all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.slab.all_reduce(g), None


class _ReplicatedSum(torch.autograd.Function):
    """Sum over the slabs of a value every rank then reads alike (the
    loss's sums): each rank's cotangent is already the total's, so it
    passes through.  An all-reduce here would make the gradients
    ``n_space`` times too large."""

    @staticmethod
    def forward(ctx, t, slab: _Slab):
        return slab.all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _check_depth(model: UNet3d, mesh: Mesh, slab_depth: int) -> None:
    levels = len(model.spec.encoders)
    if slab_depth % (1 << (levels - 1)):
        raise ValueError(f"D={slab_depth * mesh.n_space} must be divisible by "
                         f"2^{levels - 1} * {mesh.n_space}")


def make_spatial_infer(model: UNet3d, mesh: Mesh, compute_dtype=torch.bfloat16):
    """``fn(params, x)``: ``x`` this rank's slab (N, D/n, H, W, C) of the
    input (``spatial_sharding``) -> its slab of the level-0 logits, f32."""
    slab = _Slab(mesh)

    @torch.no_grad()
    def fn(params, x):
        _check_depth(model, mesh, x.shape[1])
        return forward(model.spec, params, x, compute_dtype=compute_dtype, slab=slab)[0]

    return fn


def make_spatial_train_step(model: UNet3d, mesh: Mesh, compute_dtype=torch.float32,
                            remat: bool = False):
    """The z-sharded train step: ``fn(params, opt_state, img, lab, lr) ->
    (params, opt_state, level-0 (ce, dice, mse))`` with ``img`` (1, D/n, H,
    W, C) and ``lab`` (1, D/n, H, W) this rank's slabs.  The gradients of
    the slabs are summed over the space axis, then clipped and applied
    (SGD-nesterov, in place), so the parameters stay the same on every
    rank.  No augmentation, as in the JAX package: feed augmented or raw
    volumes.  ``remat=True`` checkpoints each level: the backward reruns
    its forward, halo exchanges and slab sums included, on every rank in
    the same order."""
    spec, n_classes = model.spec, model.out_count
    slab = _Slab(mesh)
    cfg = SGDConfig()

    def step(params, opt_state, img, lab, lr):
        _check_depth(model, mesh, img.shape[1])
        names = list(params)
        leaves = [params[k].detach().requires_grad_() for k in names]
        outs = forward(spec, dict(zip(names, leaves)), img, compute_dtype=compute_dtype,
                       slab=slab, train=True, remat=remat)
        loss, lvl0 = deep_supervision_loss(outs, lab.long(), n_classes,
                                           psum=slab.psum_replicated)
        grads = list(torch.autograd.grad(loss, leaves, materialize_grads=True))
        if mesh.n_space > 1:
            all_reduce_sum(grads, mesh.space_group)
        opt_state = sgd_step(params, dict(zip(names, grads)), opt_state, lr, cfg)
        return params, opt_state, torch.stack(lvl0).detach()

    return step
