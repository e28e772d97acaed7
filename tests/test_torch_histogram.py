"""Port parity: the soft (tent) histogram and the fixed-order scatter.

Mirrors ``tests/test_trace.py::test_soft_histogram_conserves_and_differentiates``
on the port's plain versions, and holds them, the hard histogram's backward
and the scatter-add of the gradients against the JAX package on the same
NumPy inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hare_tpu as jh  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.accel.scatter import CHUNK, gather_rows, scatter_add_ordered  # noqa: E402
from hare_tpu_torch.trace.bounce import (  # noqa: E402
    hard_histogram_bwd_plain,
    soft_histogram_bwd_plain,
)

# Bin sums and their gradients: the same f32 products, summed in another
# order.
RTOL = 1e-5
SCATTER_RTOL = 1e-6


def traces(hit, energy, time):
    """The same trace record for both packages (only hit, energy and time
    are read)."""
    z = np.zeros(hit.shape, np.float32)
    pt = np.zeros(hit.shape + (3,), np.float32)
    jres = jh.TraceResult(jnp.asarray(hit), jnp.asarray(energy), jnp.asarray(time),
                          jnp.asarray(z.astype(np.int32)), jnp.asarray(pt), jnp.asarray(z))
    return jres, (torch.from_numpy(hit), torch.from_numpy(energy), torch.from_numpy(time))


def port_soft(hit, energy, time, n_bins, bin_dt, weight):
    """The port's soft histogram and d(sum(h * weight))/d(energy, time)."""
    e = energy.clone().requires_grad_()
    t = time.clone().requires_grad_()
    res = th.TraceResult(hit, e, t, None, None, None)
    h = th.energy_histogram(res, n_bins, bin_dt, soft=True)
    (h * torch.from_numpy(weight)).sum().backward()
    return h.detach().numpy(), e.grad.numpy(), t.grad.numpy()


def jax_soft(jres, n_bins, bin_dt, weight, soft=True):
    def f(e, t):
        h = jh.energy_histogram(jres._replace(energy=e, time=t), n_bins, bin_dt, soft=soft)
        return jnp.sum(h * weight), h

    (_, h), (ge, gt) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jres.energy, jres.time)
    return np.asarray(h), np.asarray(ge), np.asarray(gt)


def centre_time(k, bin_dt):
    """An f32 time whose f32 ``time / bin_dt`` is exactly ``k + 0.5``: bin
    k's centre, where the tent's clip sits on its lower bound."""
    dt = np.float32(bin_dt)
    t = np.float32((k + 0.5) * bin_dt)
    for _ in range(64):
        q = t / dt
        if q == np.float32(k + 0.5):
            return t
        t = np.nextafter(t, np.float32(np.inf) if q < k + 0.5 else np.float32(-np.inf))
    raise AssertionError("no f32 time at the bin centre")


# Edge cases of a trace record's lanes beside the documented one (K3's
# tests on the card take the same ones).
SOFT_CASES = ["documented", "one bin", "1025 bins", "every lane in one bin", "every lane dead",
              "outside the window", "on bin edges"]


def soft_lanes(rng, case):
    """``(hit, energy, time, n_bins, bin_dt)`` of a 3 x 400 trace record
    for one edge case of ``SOFT_CASES``: one bin, 1025 bins (past one tile
    of K3), every lane at one time, every lane dead, every time before or
    past the window, every time exactly on a bin edge (the tent's frac
    1/2)."""
    shape, n_bins, bin_dt = (3, 400), 32, 1e-3
    hit = rng.uniform(size=shape) < 0.8
    energy = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    time = rng.uniform(-0.005, 0.05, shape).astype(np.float32)
    if case == "one bin":
        n_bins = 1
    elif case == "1025 bins":
        n_bins = 1025
        time = rng.uniform(-0.01, 1.04, shape).astype(np.float32)
    elif case == "every lane in one bin":
        time[:] = np.float32(7.3 * bin_dt)
        hit[:] = True
    elif case == "every lane dead":
        hit[:] = False
    elif case == "outside the window":
        late = rng.uniform(size=shape) < 0.5
        time = np.where(late, n_bins * bin_dt + rng.uniform(0, 1, shape),
                        -rng.uniform(1e-6, 1, shape)).astype(np.float32)
    elif case == "on bin edges":
        bin_dt = 2.0 ** -10  # every k bin_dt exact in f32, and time / bin_dt exactly k
        time = (rng.integers(-2, n_bins + 3, shape) * bin_dt).astype(np.float32)
    return hit, energy, time, n_bins, bin_dt


@pytest.mark.parametrize("case", SOFT_CASES)
def test_soft_histogram_matches_jax(case):
    """test_soft_histogram_conserves_and_differentiates on the port: totals
    conserved (the clamped overflow included), the 0.2 / 0.3 split, the dead
    lane dropped, d(moment)/dt = energy / bin_dt; a time exactly at a bin
    centre takes JAX's clip gradient (1/2); and a random 3 x 512 trace's bins
    and d/d(energy), d/d(time) equal JAX's.  Each edge case of SOFT_CASES:
    the bins and both gradients equal JAX's, and the total the live
    energy."""
    if case != "documented":
        hit, energy, time, n_bins, bin_dt = soft_lanes(np.random.default_rng(23), case)
        weight = np.random.default_rng(5).normal(size=n_bins).astype(np.float32)
        jres, (h_t, e_t, t_t) = traces(hit, energy, time)
        got = port_soft(h_t, e_t, t_t, n_bins, bin_dt, weight)
        want = jax_soft(jres, n_bins, bin_dt, weight)
        for what, g, w in zip(("bins", "d/d(energy)", "d/d(time)"), got, want):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * float(np.abs(w).max()),
                                       err_msg=what)
        np.testing.assert_allclose(got[0].sum(), energy[hit].sum(), rtol=RTOL)
        return
    c = centre_time(3, 1e-3)
    hit = np.array([[True, True, True, False, True]])
    energy = np.array([[0.5, 0.25, 1.0, 7.0, 0.75]], np.float32)
    #              bin0/1 split  bin12/13  clamped into the last bin  dead  centre of bin 3
    time = np.array([[0.0011, 0.0129, 99.0, 1.0, c]], np.float32)
    jres, (h_t, e_t, t_t) = traces(hit, energy, time)
    moment = np.arange(16, dtype=np.float32)
    hs, ge, gt = port_soft(h_t, e_t, t_t, 16, 1e-3, moment)
    hh = th.energy_histogram(th.TraceResult(h_t, e_t, t_t, None, None, None), 16, 1e-3).numpy()
    np.testing.assert_allclose(hh.sum(), 2.5, rtol=1e-6)
    np.testing.assert_allclose(hs.sum(), 2.5, rtol=1e-6)
    # t = 1.1 ms, centres at 0.5 / 1.5 ms: frac 0.6, bin 0 gets 0.2, bin 1 0.3.
    np.testing.assert_allclose(hs[0], 0.2, rtol=1e-5)
    np.testing.assert_allclose(hs[1], 0.3, rtol=1e-5)
    np.testing.assert_allclose(hs[15], 1.0, rtol=1e-6)
    np.testing.assert_allclose(hs[3], 0.75, rtol=1e-6)
    # d(moment)/dt of the split ray = energy / bin_dt = 500; at the bin
    # centre, half of 0.75 / bin_dt (JAX's clip; torch.clamp would give all).
    np.testing.assert_allclose(gt[0, 0], 0.5 / 1e-3, rtol=1e-4)
    np.testing.assert_allclose(gt[0, 4], 0.5 * 0.75 / 1e-3, rtol=1e-4)
    assert gt[0, 3] == 0.0 and ge[0, 3] == 0.0  # the dead lane
    # The clamped overflow: frac clipped at 1, so no time gradient.
    assert gt[0, 2] == 0.0
    jh_s, jge, jgt = jax_soft(jres, 16, 1e-3, moment)
    _, _, jgt_hard = jax_soft(jres, 16, 1e-3, moment, soft=False)
    np.testing.assert_array_equal(jgt_hard, 0.0)
    for got, want in ((hs, jh_s), (ge, jge), (gt, jgt)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * float(np.abs(want).max()))

    rng = np.random.default_rng(17)
    shape, n_bins = (3, 512), 64
    hit = rng.uniform(size=shape) < 0.9
    energy = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    time = rng.uniform(-0.005, 0.07, shape).astype(np.float32)
    weight = rng.normal(size=n_bins).astype(np.float32)
    jres, (h_t, e_t, t_t) = traces(hit, energy, time)
    got = port_soft(h_t, e_t, t_t, n_bins, 1e-3, weight)
    want = jax_soft(jres, n_bins, 1e-3, weight)
    for what, g, w in zip(("bins", "d/d(energy)", "d/d(time)"), got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * float(np.abs(w).max()),
                                   err_msg=what)
    # The backward's plain version is what the Function returns on the CPU.
    de, dt = soft_histogram_bwd_plain(e_t, t_t, h_t, torch.from_numpy(weight), n_bins, 1e-3)
    assert np.array_equal(de.numpy(), got[1]) and np.array_equal(dt.numpy(), got[2])


# The hard backward's lanes: some dead, times past the window (up to 10 s)
# and before it, times exactly on bin edges, and odd lane counts.
HARD_BWD_CASES = ["dead lanes", "past the window", "before the window", "on bin edges",
                  "odd lane count", "one lane"]


def hard_bwd_lanes(rng, case):
    """``(hit, energy, time, n_bins, bin_dt)`` of a trace record for one
    case of ``HARD_BWD_CASES``."""
    shape, n_bins, bin_dt = (3, 400), 64, 1e-3
    if case == "odd lane count":
        shape = (3, 333)
    elif case == "one lane":
        shape = (1, 1)
    hit = rng.uniform(size=shape) < (0.5 if case == "dead lanes" else 0.9)
    energy = rng.uniform(0.1, 1.0, shape).astype(np.float32)
    time = rng.uniform(0.0, n_bins * bin_dt, shape).astype(np.float32)
    if case == "past the window":
        time = np.where(rng.uniform(size=shape) < 0.5, time,
                        n_bins * bin_dt + rng.uniform(0, 10, shape)).astype(np.float32)
    elif case == "before the window":
        time = np.where(rng.uniform(size=shape) < 0.5, time,
                        -rng.uniform(0, 10, shape)).astype(np.float32)
    elif case == "on bin edges":
        bin_dt = 2.0 ** -10  # every k bin_dt exact in f32, and time / bin_dt exactly k
        time = (rng.integers(-2, n_bins + 3, shape) * bin_dt).astype(np.float32)
    return hit, energy, time, n_bins, bin_dt


@pytest.mark.parametrize("case", HARD_BWD_CASES)
def test_hard_histogram_bwd_matches_jax(case):
    """The hard backward's plain version (the gather that K3's backward
    kernel computes on the card in its hard mode) against ``jax.vjp`` of
    ``energy_histogram`` w.r.t. the energies, to the bit: each hit lane
    gets its bin's cotangent, a dead lane +0.0.  The time's cotangent is
    zero in JAX and absent in the port."""
    hit, energy, time, n_bins, bin_dt = hard_bwd_lanes(np.random.default_rng(29), case)
    ct = np.random.default_rng(31).normal(size=n_bins).astype(np.float32)
    jres, (h_t, e_t, t_t) = traces(hit, energy, time)

    def jhist(e, t):
        return jh.energy_histogram(jres._replace(energy=e, time=t), n_bins, bin_dt)

    _, vjp = jax.vjp(jhist, jres.energy, jres.time)
    ge, gt = (np.asarray(x) for x in vjp(jnp.asarray(ct)))
    got = hard_histogram_bwd_plain(t_t, h_t, torch.from_numpy(ct), n_bins, bin_dt).numpy()
    assert got.dtype == np.float32 and got.shape == energy.shape
    assert np.array_equal(got.view(np.uint32), ge.view(np.uint32))
    assert not np.signbit(got[~hit]).any() and (got[~hit] == 0).all()
    np.testing.assert_array_equal(gt, 0.0)
    # Through the port's histogram: the same d(energy), and no d(time).
    e = e_t.clone().requires_grad_()
    t = t_t.clone().requires_grad_()
    th.energy_histogram(th.TraceResult(h_t, e, t, None, None, None), n_bins, bin_dt).backward(
        torch.from_numpy(ct))
    assert np.array_equal(e.grad.numpy().view(np.uint32), ge.view(np.uint32))
    assert t.grad is None


def chunk_fold(keys, values, n_keys):
    """The fixed order in numpy: each chunk of CHUNK original positions, a
    key's values added in index order to a float32 zero, then the chunks'
    sums added in order to a float32 zero."""
    fold = np.zeros((n_keys,) + values.shape[1:], np.float32)
    for s in range(0, keys.shape[0], CHUNK):
        part = np.zeros_like(fold)
        for i in range(s, min(s + CHUNK, keys.shape[0])):
            part[keys[i]] = part[keys[i]] + values[i]
        fold = fold + part
    return fold


@pytest.mark.parametrize("cols", [1, 3])
def test_scatter_add_ordered_plain(cols):
    """The fixed-order scatter's plain version against JAX's segment_sum on
    random keys with repeats and unused keys, over three chunks; to the bit,
    each key's values in a chunk of CHUNK original positions added in
    increasing index order (a float32 left fold from zero), then the
    chunks' sums in order; and the gather whose gradient it is."""
    rng = np.random.default_rng(5)
    m, n_keys = 3000, 40
    keys = rng.choice(np.arange(0, n_keys, 2), m).astype(np.int32)  # odd keys unused
    shape = (m,) if cols == 1 else (m, cols)
    values = (rng.normal(size=shape) * rng.uniform(0, 1e3, (m,) + (1,) * (cols > 1))).astype(
        np.float32)
    got = scatter_add_ordered(torch.from_numpy(keys), torch.from_numpy(values), n_keys).numpy()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(keys),
                                          num_segments=n_keys))
    np.testing.assert_allclose(got, want, rtol=SCATTER_RTOL,
                               atol=SCATTER_RTOL * float(np.abs(want).max()))
    assert (got[1::2] == 0).all()
    assert np.array_equal(got.view(np.uint32), chunk_fold(keys, values, n_keys).view(np.uint32))
    table = torch.from_numpy(rng.normal(size=(n_keys,) + shape[1:]).astype(np.float32))
    table.requires_grad_()
    gather_rows(table, torch.from_numpy(keys)).backward(torch.from_numpy(values))
    assert np.array_equal(table.grad.numpy(), got)


def _one_key_across_chunks(rng):
    """One key's run across three chunks, its last value alone in a chunk."""
    m = 2 * CHUNK + 1
    return np.full(m, 3, np.int32), rng.normal(size=m).astype(np.float32), 5


def _unused_keys(rng):
    """Most keys never used: every 97th of 10,000, over two chunks."""
    m = CHUNK + 700
    return (rng.integers(0, 40, m) * 97).astype(np.int32), rng.normal(size=m).astype(
        np.float32), 10_000


def _signed_zeros(rng):
    """Values of -0.0 and +0.0 only, and runs of -0.0 alone, across chunks:
    every sum, even of -0.0s, is +0.0."""
    m = CHUNK + 10
    keys = rng.integers(0, 6, m).astype(np.int32)
    keys[-10:] = 7  # a run of -0.0 alone, in the second chunk
    values = np.where(rng.uniform(size=m) < 0.5, -0.0, 0.0).astype(np.float32)
    values[keys == 7] = -0.0
    return keys, values, 8


@pytest.mark.parametrize("case", [_one_key_across_chunks, _unused_keys, _signed_zeros],
                         ids=["run_across_chunks", "unused_keys", "signed_zeros"])
def test_scatter_add_ordered_plain_chunks(case):
    """The chunk order on edges: a run that crosses chunks, unused keys
    (zero), signed zeros (no -0.0 out); to the bit against the numpy fold,
    and against JAX's segment_sum within SCATTER_RTOL."""
    keys, values, n_keys = case(np.random.default_rng(11))
    got = scatter_add_ordered(torch.from_numpy(keys), torch.from_numpy(values), n_keys).numpy()
    assert np.array_equal(got.view(np.uint32), chunk_fold(keys, values, n_keys).view(np.uint32))
    assert not np.signbit(got[got == 0]).any()
    assert (got[np.setdiff1d(np.arange(n_keys), keys)] == 0).all()
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(values), jnp.asarray(keys),
                                          num_segments=n_keys))
    np.testing.assert_allclose(got, want, rtol=SCATTER_RTOL,
                               atol=SCATTER_RTOL * max(float(np.abs(want).max()), 1e-30))
