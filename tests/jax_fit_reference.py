"""The JAX package's two inverse-design loops on given rays: the reference
the port's programs (``hare_tpu_torch.examples``) are held against.

Each loop is the JAX example's (``examples/fit_absorption.py``,
``examples/fit_vertices.py``), built from ``hare_tpu.dist`` and
``optax.adam``, with the ray directions handed in instead of drawn from a
JAX key.  ``tests/test_torch_examples.py`` runs them at a small size beside
the port.  Run as a script (on the CPU, JAX and the port both installed),
it runs them at the programs' defaults (32,768 rays, 8 bounces, 1024 bins)
on the port's own rays (``uniform_sphere`` with a CPU generator of seed 0)
and prints, one JSON line each, what they reach: the gates of
``chip_smoke.py`` phase 11::

    JAX_PLATFORMS=cpu python tests/jax_fit_reference.py
"""

from __future__ import annotations

import json
import sys

import numpy as np

import jax
import jax.numpy as jnp
import optax

import hare_tpu as jh
from hare_tpu.dist import make_ray_mesh, make_train_step, sharded_histogram
from hare_tpu.mesh import shapes as jshapes
from hare_tpu.utils import HareConfig

ABS_SOURCE, VERT_SOURCE = (15.0, 24.0, 8.0), (2.0, 2.5, 1.5)
# The default program: steps, and (for the vertex fit) steps between rebuilds.
ABS_STEPS, VERT_STEPS, VERT_INNER, ACCEL_STEPS = 60, 100, 25, 5
# The draw streams (JAX keys) the scattering fit is run with.
DRAW_KEYS = (0, 1, 2)


def jax_fit_absorption(d, steps, n_bounces, n_bins, accel="grid", seed=0, fit_scattering=False,
                       key_seed=0, mesh=None):
    """``examples/fit_absorption.py``'s loop from sigmoid(0) on directions
    ``d`` (N, 3) from the hall's source: returns every step's loss, the
    final mean |a - a_true| (and |s - s_true| with its start) and the
    parameters."""
    cfg = HareConfig(accel=accel, n_bounces=n_bounces, n_bins=n_bins, seed=seed)
    top = jh.Topology.build(jshapes.concert_hall())
    sp = jh.SpatialPartition(top, accel=cfg.accel, kernel=cfg.kernel, **cfg.accel_params())
    mesh = mesh or make_ray_mesh()
    n = len(d)
    rays = jh.Ray.make(np.tile(np.float32([ABS_SOURCE]), (n, 1)), np.asarray(d, np.float32))
    rng = np.random.default_rng(cfg.seed)
    a_true = jnp.asarray(rng.uniform(0.1, 0.7, top.n_polys), jnp.float32)
    key = jax.random.PRNGKey(key_seed)
    hist_fn = sharded_histogram(mesh, sp.shoot_fn, cfg.n_bounces, cfg.n_bins, cfg.bin_dt,
                                use_scattering=fit_scattering)
    extra = ()
    if fit_scattering:
        s_true = jnp.asarray(rng.uniform(0.2, 0.8, top.n_polys), jnp.float32)
        extra = (s_true, key)
    target = hist_fn(sp.scene, rays, a_true, sp.aux, *extra)
    opt = optax.adam(0.1)
    params = {"absorption": jnp.zeros(top.n_polys, jnp.float32)}
    if fit_scattering:
        params["scattering"] = jnp.zeros(top.n_polys, jnp.float32)
    opt_state = opt.init(params)
    step_fn = make_train_step(mesh, sp.shoot_fn, opt, cfg.n_bounces, cfg.n_bins, cfg.bin_dt,
                              use_scattering=fit_scattering)
    step_extra = (key,) if fit_scattering else ()
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step_fn(params, opt_state, sp.scene, rays, target, sp.aux,
                                          *step_extra)
        losses.append(float(loss))
    out = dict(losses=losses, params={k: np.asarray(v) for k, v in params.items()},
               err=float(jnp.abs(jax.nn.sigmoid(params["absorption"]) - a_true).mean()))
    if fit_scattering:
        out["err_s"] = float(jnp.abs(jax.nn.sigmoid(params["scattering"]) - s_true).mean())
        out["err_s0"] = float(jnp.abs(0.5 - s_true).mean())
    return out


def extents(v):
    return v.max(axis=0) - v.min(axis=0)


def jax_fit_vertices(d, steps, inner, n_bounces, n_bins, mesh=None):
    """``examples/fit_vertices.py``'s loop on directions ``d`` from the
    shoebox's source: returns every step's loss, each round's vertices (as
    rebuilt) and the final largest extent error."""
    cfg = HareConfig(n_bounces=n_bounces, n_bins=n_bins)
    mesh = mesh or make_ray_mesh()
    faces0 = jshapes.shoebox(4.0, 5.0, 3.0)
    scale = np.array([1.08, 0.96, 1.04], np.float32)
    top_true = jh.Topology.build([f * scale for f in faces0])
    sp_true = jh.SpatialPartition(top_true, accel=cfg.accel, kernel=cfg.kernel,
                                  **cfg.accel_params())
    a_fixed = jnp.full(top_true.n_polys, 0.2, jnp.float32)
    n = len(d)
    rays = jh.Ray.make(np.tile(np.float32([VERT_SOURCE]), (n, 1)), np.asarray(d, np.float32))
    hist_kw = dict(n_bounces=cfg.n_bounces, n_bins=cfg.n_bins, bin_dt=cfg.bin_dt, soft=True)
    target = sharded_histogram(mesh, sp_true.shoot_fn, **hist_kw)(
        sp_true.scene, rays, a_fixed, sp_true.aux)
    opt = optax.adam(2e-2)
    a_raw = jnp.full(top_true.n_polys, float(np.log(0.2 / 0.8)), jnp.float32)
    top = jh.Topology.build(faces0)
    losses, rounds, i = [], [], 0
    while i < steps:
        sp = jh.SpatialPartition(top, accel=cfg.accel, kernel=cfg.kernel, **cfg.accel_params())
        step_fn = make_train_step(mesh, sp.shoot_fn, opt, fit_vertices=True,
                                  n_bounces=cfg.n_bounces, n_bins=cfg.n_bins, bin_dt=cfg.bin_dt)
        params = {"absorption": a_raw, "vertices": sp.scene.vertices}
        opt_state = opt.init(params)
        for _ in range(min(inner, steps - i)):
            params, opt_state, loss = step_fn(params, opt_state, sp.scene, rays, target, sp.aux)
            losses.append(float(loss))
            i += 1
        a_raw = params["absorption"]
        v_est = np.asarray(params["vertices"])
        rounds.append((v_est, np.asarray(a_raw)))
        top = jh.Topology.from_indexed(v_est, top.poly_verts)
    ext_err = float(np.abs(extents(np.asarray(top.vertices)) - extents(top_true.vertices)).max())
    return dict(losses=losses, rounds=rounds, ext_err=ext_err)


def port_directions(n, seed=0):
    """The port's default rays: ``uniform_sphere`` with a CPU generator."""
    import torch

    from hare_tpu_torch.trace import uniform_sphere

    return uniform_sphere(n, torch.Generator().manual_seed(seed), device="cpu").numpy()


def main():
    mesh = make_ray_mesh(1)
    d = port_directions(1 << 15)
    runs = [("fit_absorption", dict(steps=ABS_STEPS))]
    runs += [(f"fit_absorption --accel {a}", dict(steps=ACCEL_STEPS, accel=a))
             for a in ("brute", "octree", "kdtree", "kdtree_ropes")]
    runs += [(f"fit_absorption --fit-scattering, draw key {k}",
              dict(steps=ABS_STEPS, fit_scattering=True, key_seed=k)) for k in DRAW_KEYS]
    for name, kw in runs:
        r = jax_fit_absorption(d, n_bounces=8, n_bins=1024, mesh=mesh, **kw)
        line = dict(program=name, first_loss=r["losses"][0], last_loss=r["losses"][-1],
                    reduction=r["losses"][0] / r["losses"][-1], err=r["err"])
        for k in ("err_s", "err_s0"):
            if k in r:
                line[k] = r[k]
        print(json.dumps(line), flush=True)
    r = jax_fit_vertices(port_directions(1 << 15), VERT_STEPS, VERT_INNER, 8, 1024, mesh=mesh)
    print(json.dumps(dict(program="fit_vertices", first_loss=r["losses"][0],
                          last_loss=r["losses"][-1],
                          reduction=r["losses"][0] / r["losses"][-1], ext_err=r["ext_err"])),
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
