"""Port parity: ``Scene.tri_normals`` against ``hare_tpu``'s, values and
vertex gradients, on a shoebox and an icosphere packed by ``build_scene``,
without and with pad rows."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu as jh  # noqa: E402
from hare_tpu.mesh import shapes as jshapes  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.mesh import PAD_POLY, shapes  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

# The same f32 cross products and normalisation, and their transposes.
RTOL = ATOL = 1e-5


def faces(sh):
    return [sh.shoebox(4, 5, 3), sh.icosphere(1, radius=1.0, center=(2.0, 2.5, 1.5))]


@pytest.mark.parametrize("pad_to", [1, 128])
@pytest.mark.parametrize("unit", [True, False])
def test_tri_normals_match_jax(unit, pad_to):
    """Values and the gradient of a seeded weighted sum of the normals w.r.t.
    the vertices, against ``jax.grad``; with pad rows (``pad_to=128``) each
    pad row's normal is zero, and weights on the pad rows alone give a zero
    gradient."""
    jscene = jh.build_scene([jh.Topology.build(f) for f in faces(jshapes)], pad_to=pad_to)
    scene = th.build_scene([th.Topology.build(f) for f in faces(shapes)], pad_to=pad_to,
                           device=CPU)
    n_tris = scene.n_tris
    pad = scene.tri_poly.numpy() == PAD_POLY
    assert n_tris == jscene.tri_v.shape[0] and pad.any() == (pad_to == 128)
    w = np.random.default_rng(3).normal(size=(n_tris, 3)).astype(np.float32)

    def jloss(v, w):
        return jnp.sum(w * jscene._replace(vertices=v).tri_normals(unit))

    def loss(w):
        v = scene.vertices.clone().requires_grad_()
        n = scene._replace(vertices=v).tri_normals(unit)
        torch.sum(torch.from_numpy(w) * n).backward()
        return n.detach().numpy(), v.grad.numpy()

    n, g = loss(w)
    n_j = np.asarray(jscene.tri_normals(unit))
    g_j = np.asarray(jax.grad(jloss)(jscene.vertices, w))
    np.testing.assert_allclose(n, n_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g, g_j, rtol=RTOL, atol=ATOL * float(np.abs(g_j).max()))
    assert (np.abs(n[~pad]).max(1) > 0).all()
    if unit:
        np.testing.assert_allclose(np.linalg.norm(n[~pad], axis=1), 1.0, rtol=RTOL)
    if pad.any():
        assert (n[pad] == 0).all()
        n_pad, g_pad = loss(np.where(pad[:, None], w, np.float32(0)))
        assert (g_pad == 0).all() and (n_pad[pad] == 0).all()
        assert (np.asarray(jax.grad(jloss)(jscene.vertices, np.where(pad[:, None], w, 0))) == 0
                ).all()
