"""Ray-parallel histograms and training over ``torch.distributed``.

Counterpart of ``hare_tpu/dist/sharding.py``.  The JAX package shards the
ray batch over a 1-D device mesh (``P('rays')``), replicates the scene and
the materials, ``psum``s the per-device histograms, and lets shard_map's
transpose sum the replicated parameters' gradients.  Here a process group
(default ``WORLD``) takes the mesh's place, one rank a device:

- every rank is handed the whole ray batch and traces its contiguous block,
  ``rays[rank * m:(rank + 1) * m]`` with ``m = N / world_size``, as
  ``P('rays')`` splits it; a count the world size does not divide raises;
- the scene, the structure, absorption, scattering and vertices are
  replicated: every rank holds the same values;
- the local histograms are summed with ``all_reduce`` (:class:`_SumOverRanks`:
  all-reduce forward, identity backward), so every rank holds the global
  histogram and the loss on it;
- each replicated parameter enters through :class:`_Replicated` (identity
  forward, all-reduce backward): its gradient is the sum over ranks of the
  local gradients, what shard_map's transpose gives every device.  An
  all-reduce inside a loss that every rank computes, with an all-reduce in
  its backward too (``torch.distributed.nn.functional.all_reduce``), would
  multiply the gradients by the world size.

On the card the backend is NCCL, one rank a device; on the CPU it is gloo.
Each rank's trace runs the port's kernels (K1-K4 on CUDA tensors).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..geom.primitives import HitRecord, Ray
from ..mesh.scene import Scene
from ..trace.bounce import SOUND_SPEED, energy_histogram, scatter_draws, trace_rays
from ..utils.checks import check_finite

__all__ = ["backend_for", "init_distributed", "make_train_step", "sharded_histogram"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The process group backend for tensors on ``device``: NCCL on the
    card, gloo on the CPU.  It follows the device named, never what the host
    happens to offer."""
    kind = torch.device(device).type
    if kind not in _BACKENDS:
        raise ValueError(f"no process group backend for device type {kind!r}")
    return _BACKENDS[kind]


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     **kwargs) -> None:
    """Join the default process group (``hare_tpu/dist/sharding.py:40``):
    ``torch.distributed.init_process_group`` with :func:`backend_for`
    ``device``, and ``init_method`` (e.g. ``tcp://localhost:<port>`` or
    ``file://<path>``), ``world_size`` and ``rank`` as given; nothing tells
    a program of a cluster, so pass them.  For the card, the rank's device
    is ``device``'s index, else the rank modulo the cards the host has.
    A no-op where the group is already initialized."""
    if dist.is_initialized():
        return
    backend = backend_for(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            **kwargs)
    if backend == "nccl":
        index = torch.device(device).index
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count() if index is None
                              else index)


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce`` (sum) forward, identity backward: every rank's loss is
    a function of the global histogram, and each rank's cotangent of it goes
    to its own local histogram alone (the transpose of ``psum`` on a
    replicated cotangent)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Replicated(torch.autograd.Function):
    """Identity forward, ``all_reduce`` (sum) backward: a replicated
    parameter's gradient summed over the ranks' local gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def _replicated(x: Optional[torch.Tensor], group) -> Optional[torch.Tensor]:
    """``x`` as a replicated parameter: through :class:`_Replicated` where
    it takes a gradient, as it is otherwise."""
    if x is None or not (x.requires_grad and torch.is_grad_enabled()):
        return x
    return _Replicated.apply(x, group)


def _block(n: int, group) -> slice:
    """This rank's contiguous block of ``n`` rays."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if n % world:
        raise ValueError(f"{n} rays do not split evenly over {world} ranks")
    m = n // world
    return slice(rank * m, (rank + 1) * m)


def _local_histogram(shoot_fn, n_bounces, n_bins, bin_dt, sound_speed, soft, group, scene,
                     rays, absorption, aux, scattering, generator):
    """This rank's rays traced and binned, the histogram summed over the
    ranks; the parameters already replicated."""
    block = _block(rays.origin.shape[0], group)
    local = Ray(*(x[block] for x in rays))
    draws = None
    if scattering is not None:
        if generator is None:
            raise ValueError("scattering requires a torch.Generator (generator=)")
        full = scatter_draws(generator, n_bounces, rays.origin.shape[0], rays.origin.dtype,
                             rays.origin.device)
        draws = tuple(x[:, block] for x in full)
    res = trace_rays(scene, local, absorption, n_bounces, shoot_fn, aux=aux,
                     scattering=scattering, sound_speed=sound_speed, draws=draws)
    return _SumOverRanks.apply(energy_histogram(res, n_bins, bin_dt, soft=soft), group)


def sharded_histogram(
    shoot_fn: Callable[..., HitRecord],
    n_bounces: int,
    n_bins: int,
    bin_dt: float = 1e-3,
    sound_speed: float = SOUND_SPEED,
    use_scattering: bool = False,
    soft: bool = False,
    group=None,
):
    """``fn(scene, rays, absorption, aux=None, scattering=None,
    generator=None) -> histogram`` (``hare_tpu/dist/sharding.py:64``): each
    rank traces its block of ``rays`` (the whole batch, on every rank) and
    every rank returns the histogram summed over ``group``'s ranks.

    Differentiable in ``absorption``, ``scattering`` and ``scene.vertices``
    (``scene.with_vertices``): every rank gets the sum over ranks of the
    local gradients, the single-process gradient up to the order of that
    sum.  ``soft=True`` bins with the tent histogram.

    ``use_scattering``: ``scattering`` and a ``torch.Generator`` are
    required, seeded alike on every rank.  The generator draws the whole
    batch's draws, ray-major (:func:`~..trace.bounce.scatter_draws`), and
    each rank takes its rays' columns, so the sharded trace is the
    single-process trace of the same seed ray for ray.  The JAX package
    instead folds the device's mesh index into its key (:96), a different,
    equally unbiased sample.
    """

    def fn(scene: Scene, rays: Ray, absorption: torch.Tensor, aux=None,
           scattering: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if use_scattering and scattering is None:
            raise ValueError("use_scattering=True takes scattering coefficients")
        scene = scene._replace(vertices=_replicated(scene.vertices, group))
        return _local_histogram(
            shoot_fn, n_bounces, n_bins, bin_dt, sound_speed, soft, group, scene, rays,
            _replicated(absorption, group), aux,
            _replicated(scattering, group) if use_scattering else None, generator)

    return fn


def make_train_step(
    shoot_fn: Callable[..., HitRecord],
    optimizer: torch.optim.Optimizer,
    n_bounces: int,
    n_bins: int,
    bin_dt: float = 1e-3,
    fit_vertices: bool = False,
    use_scattering: bool = False,
    soft: Optional[bool] = None,
    group=None,
    sound_speed: float = SOUND_SPEED,
):
    """One sharded training step of inverse acoustic design
    (``hare_tpu/dist/sharding.py:120``): ``step(params, scene, rays,
    target, aux=None, generator=None) -> loss``.

    ``params`` is a dict of leaf tensors that ``optimizer`` (a
    ``torch.optim`` optimizer over them) updates in place: ``'absorption'``
    (P,) and, with ``use_scattering``, ``'scattering'`` (P,), each through a
    sigmoid into (0, 1); with ``fit_vertices``, ``'vertices'`` (V, 3), which
    enter as ``scene.with_vertices``.  The loss is ``sum((hist - target)^2)
    / n_bins`` of the histogram summed over the ranks; each raw parameter's
    gradient is summed over the ranks before the update, so every rank
    takes the same step.  ``soft`` (the binning) defaults to
    ``fit_vertices``: the vertices reach the histogram through arrival
    times, which the hard bins do not differentiate; build ``target`` with
    the same binning.  With scattering, pass a generator seeded alike on
    every rank (a fresh one of one seed each step repeats the draws, as the
    JAX package's one key does); the draws are the whole batch's, split by
    ray (:func:`sharded_histogram`).  With ``utils.enable_debug_checks``
    on, a NaN in the loss or the updated parameters raises
    ``FloatingPointError``.
    """
    soft_hist = fit_vertices if soft is None else soft

    def step(params: Dict[str, torch.Tensor], scene: Scene, rays: Ray, target: torch.Tensor,
             aux=None, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        a = torch.sigmoid(_replicated(params["absorption"], group))
        if fit_vertices:
            scene = scene.with_vertices(_replicated(params["vertices"], group))
        s = None
        if use_scattering:
            s = torch.sigmoid(_replicated(params["scattering"], group))
        hist = _local_histogram(shoot_fn, n_bounces, n_bins, bin_dt, sound_speed, soft_hist,
                                group, scene, rays, a, aux, s, generator)
        loss = torch.sum((hist - target) ** 2) / n_bins
        loss.backward()
        optimizer.step()
        check_finite("make_train_step", loss, *params.values())
        return loss.detach()

    return step
