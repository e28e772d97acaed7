"""Port parity: the four Pallas probe kernels against the port's plain versions.

Each JAX probe of ``benchmarks/`` is loaded from its file and run at a small
size on the CPU, with its module's ``pl`` pointed at a stand-in whose
``pallas_call`` runs the real one in interpret mode and its ``jax.jit`` made
the identity, so that every kernel call and its concrete inputs are
recorded.  The tests then check that the port's input builders give the JAX
probe's arrays bit for bit, and hold the recorded Pallas kernel, run on
those inputs, against the port's plain version: int32 exactly, float32
within ``pallas_probe.sums_agree``'s bound.  Nothing in ``benchmarks/``
changes.
"""

import importlib.util
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as real_pl  # noqa: E402

from hare_tpu_torch.benchmarks import pallas_probe as tp  # noqa: E402
from hare_tpu_torch.benchmarks import r4_dyngather_probe as tr4  # noqa: E402
from hare_tpu_torch.utils import tracing  # noqa: E402
from test_torch_cuda import GATHER_EDGES  # noqa: E402  (the gather kernel's edge shapes)

ROOT = Path(__file__).resolve().parents[1]


class _Jax:
    """The module's ``jax`` with ``jit`` the identity: the recorded kernel
    is then called with concrete arrays instead of tracers."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn):
        return fn


@pytest.fixture
def jax_probe(monkeypatch):
    """Load a JAX probe module from its file; return it and the list of
    ``(kernel, inputs)`` of every Pallas kernel call it makes."""
    calls = []

    def pallas_call(*args, **kwargs):
        kernel = real_pl.pallas_call(*args, interpret=True, **kwargs)

        def record(*inputs):
            calls.append((kernel, inputs))
            return kernel(*inputs)

        return record

    def load(rel):
        monkeypatch.setattr(sys, "path", list(sys.path))  # r4 inserts the repo root
        spec = importlib.util.spec_from_file_location(f"jax_{Path(rel).stem}", ROOT / rel)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        monkeypatch.setattr(mod, "pl", types.SimpleNamespace(
            pallas_call=pallas_call, BlockSpec=real_pl.BlockSpec))
        monkeypatch.setattr(mod, "jax", _Jax())
        return mod, calls

    return load


def assert_bit_equal(jax_array, np_array):
    a = np.asarray(jax_array)
    assert a.dtype == np_array.dtype and a.shape == np_array.shape
    assert a.tobytes() == np_array.tobytes()


def assert_sums_agree(jax_out, plain, abs_terms):
    got = torch.from_numpy(np.asarray(jax_out).copy())
    assert got.dtype == plain.dtype
    assert tp.sums_agree(got, plain, abs_terms)


def run_recorded(calls, *inputs):
    kernel, _ = calls[0]
    return np.asarray(kernel(*inputs))


@pytest.mark.parametrize("mb", [0.1, 0.5])
def test_column_sum_matches_pallas(jax_probe, mb):
    mod, calls = jax_probe("benchmarks/pallas_probe.py")
    assert mod.probe_vmem(mb) is True  # the JAX probe returns a string on failure
    (x_jax,) = calls[0][1]
    x = tp.vmem_table(mb)
    assert_bit_equal(x_jax, x)
    xt = torch.from_numpy(x)
    out = run_recorded(calls, x)
    assert out.shape == (1, 192)
    np.testing.assert_array_equal(out, tp.column_sum_plain(xt).numpy())  # integer sums
    # The recorded kernel on a random table of the same shape.
    r = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    rt = torch.from_numpy(r)
    assert_sums_agree(run_recorded(calls, r), tp.column_sum_plain(rt),
                      tp.column_sum_plain(rt.abs()))


@pytest.mark.parametrize("n_rows, R, iters", [(300, 64, 5), (7, 16, 20)],
                         ids=["probe", "wrap"])
def test_gather_matches_pallas(jax_probe, n_rows, R, iters):
    mod, calls = jax_probe("benchmarks/pallas_probe.py")
    ms, ns = mod.probe_gather(n_rows=n_rows, R=R, iters=iters)
    assert ms > 0 and ns > 0
    table, idx = tp.gather_inputs(n_rows, R)
    for got, want in zip(calls[0][1], (table, idx)):
        assert_bit_equal(got, want)
    tt, it = torch.from_numpy(table), torch.from_numpy(idx)
    plain = tp.gather_sum_plain(tt, it, iters)
    assert_sums_agree(run_recorded(calls, table, idx), plain,
                      tp.gather_sum_plain(tt.abs(), it, iters))


@pytest.mark.parametrize("n_cells, R, iters", [(500, 256, 5), (13, 64, 40)],
                         ids=["probe", "wrap"])
def test_meta_gather_matches_pallas(jax_probe, n_cells, R, iters):
    mod, calls = jax_probe("benchmarks/pallas_probe.py")
    mod.probe_meta_gather(n_cells, R, iters)
    table, idx = tp.meta_gather_inputs(n_cells, R)
    for got, want in zip(calls[0][1], (table, idx)):
        assert_bit_equal(got, want)
    it = torch.from_numpy(idx)
    out = run_recorded(calls, table, idx)
    np.testing.assert_array_equal(out, tp.gather_sum_plain(torch.from_numpy(table), it, iters).numpy())
    # Rows near 2^31: the int32 sums wrap, in JAX and in the plain version alike.
    big = np.random.default_rng(2).integers(2**30, 2**31, size=table.shape).astype(np.int32)
    out = run_recorded(calls, big, idx)
    plain = tp.gather_sum_plain(torch.from_numpy(big), it, iters)
    assert plain.dtype == torch.int32
    np.testing.assert_array_equal(out, plain.numpy())


R4_CASES = [
    (500, 2, jnp.int32, np.int32, 4),
    (256, 16, jnp.float32, np.float32, 4),
    (64, 384, jnp.float32, np.float32, 3),
    (5, 8, jnp.float32, np.float32, 12),  # iters > A: the wrap
]


@pytest.mark.parametrize("A, B, jdtype, dtype, iters", R4_CASES,
                         ids=["meta_i32", "f32", "win_f32", "wrap"])
def test_r4_probe_matches_pallas(jax_probe, capsys, A, B, jdtype, dtype, iters):
    mod, calls = jax_probe("benchmarks/r4_dyngather_probe.py")
    mod.probe(A, B, jdtype, iters, "probe")
    assert "FAILED" not in capsys.readouterr().out
    tab, idx = tr4.probe_inputs(A, B, dtype)
    for got, want in zip(calls[0][1], (tab, idx)):
        assert_bit_equal(got, want)
    tt, it = torch.from_numpy(tab), torch.from_numpy(idx.reshape(-1))
    plain = tp.gather_sum_plain(tt, it, iters, torch.float32)
    out = run_recorded(calls, tab, idx)
    if dtype == np.int32:  # small integers: exact in float32
        np.testing.assert_array_equal(out, plain.numpy())
    else:
        assert_sums_agree(out, plain, tp.gather_sum_plain(tt.abs(), it, iters, torch.float32))


def numpy_gather_sum(tab, idx, iters, int_sums):
    """Every term of every window gathered at once: int32 sums exactly in
    int64, wrapped to int32; float sums in float64, with the sum of the
    terms' magnitudes."""
    rows = (idx.astype(np.int64)[:, None] + np.arange(iters)) % tab.shape[0]
    if int_sums:
        total = tab.astype(np.int64)[rows].sum(axis=(1, 2))
        return ((total + 2**31) % 2**32 - 2**31).astype(np.int32), None
    terms = tab.astype(np.float64)[rows]
    return terms.sum(axis=(1, 2)), np.abs(terms).sum(axis=(1, 2))


@pytest.mark.parametrize("case", GATHER_EDGES, ids=[c[0] for c in GATHER_EDGES])
def test_gather_sum_plain_matches_numpy(case):
    _, n, width, dtype, out_dtype, n_idx, iters = case
    rng = np.random.default_rng(11)
    if dtype == np.int32:  # full range where the sums wrap, else exact in float32
        hi = 2**31 if out_dtype == torch.int32 else 1000
        tab = rng.integers(-hi, hi, size=(n, width)).astype(np.int32)
    else:
        tab = rng.normal(size=(n, width)).astype(np.float32)
    idx = rng.integers(-n, n, size=n_idx).astype(np.int32)  # negative indices wrap
    plain = tp.gather_sum_plain(torch.from_numpy(tab), torch.from_numpy(idx), iters, out_dtype)
    want, abs_terms = numpy_gather_sum(tab, idx, iters, out_dtype == torch.int32)
    assert plain.dtype == out_dtype and plain.shape == (n_idx,)
    if out_dtype == torch.int32:
        np.testing.assert_array_equal(plain.numpy(), want)
    else:
        assert tp.sums_agree(plain, torch.from_numpy(want), torch.from_numpy(abs_terms))


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the wrappers return their plain versions' results and
    count no launch."""
    before = tracing.snapshot().counters
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(100, 8)).astype(np.float32))
    assert torch.equal(tp.column_sum(x), tp.column_sum_plain(x))
    table, idx = (torch.from_numpy(a) for a in tp.meta_gather_inputs(50, 40))
    assert torch.equal(tp.gather_sum(table, idx, 60), tp.gather_sum_plain(table, idx, 60))
    assert torch.equal(tp.gather_sum(table, idx, 3, torch.float32),
                       tp.gather_sum_plain(table, idx, 3, torch.float32))
    assert tracing.snapshot().counters == before


def test_gather_sum_plain_by_hand():
    tab = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    idx = torch.tensor([2, 0, -1], dtype=torch.int32)
    # rows visited: (2, 0, 1, 2), (0, 1, 2, 0), (2, 0, 1, 2): -1 wraps to 2.
    want = torch.tensor([11 + 3 + 7 + 11, 3 + 7 + 11 + 3, 11 + 3 + 7 + 11], dtype=torch.int32)
    assert torch.equal(tp.gather_sum_plain(tab, idx, 4), want)
    assert torch.equal(tp.gather_sum_plain(tab, idx, 0), torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("bad, exc", [
    (lambda: tp.gather_sum(torch.zeros(4, 2), torch.zeros(3, dtype=torch.int32), 2,
                           torch.int32), TypeError),
    (lambda: tp.gather_sum(torch.zeros(4, 2, dtype=torch.float64),
                           torch.zeros(3, dtype=torch.int32), 2), TypeError),
    (lambda: tp.gather_sum(torch.zeros(4, 2), torch.zeros(3, dtype=torch.int64), 2), TypeError),
    (lambda: tp.gather_sum(torch.zeros(0, 2), torch.zeros(3, dtype=torch.int32), 2), ValueError),
    (lambda: tp.gather_sum(torch.zeros(4, 2), torch.zeros(3, dtype=torch.int32), -1), ValueError),
    (lambda: tp.column_sum(torch.zeros(4, 6)), ValueError),
    (lambda: tp.column_sum(torch.zeros(4, 8, dtype=torch.int32)), TypeError),
], ids=["sum_type", "table_type", "idx_type", "empty", "iters", "columns", "col_type"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad, exc):
    with pytest.raises(exc):
        bad()


def test_builders_match_the_jax_shapes():
    assert tp.vmem_table(8).shape == (10416, 192)
    assert tp.vmem_table(120).shape == (156250, 192)
    for A, B, dtype, _, _ in tr4.CALLS[::2]:
        tab, idx = tr4.probe_inputs(A, B, dtype)
        assert tab.shape == (A, B) and tab.dtype == dtype and idx.shape == (A, 1)
        assert idx.min() >= 0 and idx.max() < A


def test_timed_probes_need_a_card():
    """The probes time the card; on the CPU they raise instead of timing it."""
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.probe_gather(n_rows=10, R=4, iters=2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tr4.probe(10, 2, np.int32, 2, "cpu", device="cpu")
    assert tp.probe_vmem(0.01, device="cpu") is True


def test_probe_main_needs_a_card():
    """``python -m`` of either probe fails, printing no result, without a card."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for mod in ("pallas_probe", "r4_dyngather_probe"):
        proc = subprocess.run(
            [sys.executable, "-m", f"hare_tpu_torch.benchmarks.{mod}"],
            cwd=ROOT, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0
        assert "ms" not in proc.stdout
