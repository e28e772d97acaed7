"""Port parity: the two inverse-design programs
(``hare_tpu_torch.examples``) against the JAX package's loops.

Each program's loop runs a few steps at 512 rays, 3 bounces and 64 bins on
the same rays in both packages: the port's ``setup`` / ``fit`` over a gloo
group of one, the JAX loop (``tests/jax_fit_reference.py``, built from
``hare_tpu.dist`` and ``optax.adam``) on its 8-device CPU mesh.  Each
program's ``main`` also runs end to end on the CPU at a tiny size, with
its metrics, checkpoint and resume.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax_fit_reference import jax_fit_absorption, jax_fit_vertices  # noqa: E402

import hare_tpu_torch as th  # noqa: E402
from hare_tpu_torch.examples import fit_absorption, fit_vertices  # noqa: E402
from hare_tpu_torch.examples._group import join_group, leave_group  # noqa: E402
from hare_tpu_torch.utils import HareConfig, determinism_check, latest_step  # noqa: E402

# The port's entry points place tensors on "cuda" unless told otherwise;
# these tests run the plain versions on the CPU.
CPU = "cpu"

N_RAYS, N_BOUNCES, N_BINS = 512, 3, 64
ABS_STEPS, VERT_STEPS, VERT_INNER = 3, 3, 2
# Losses: the histograms agree to f32 rounding (tests/test_torch_dist.py's
# LOSS_RTOL).  Parameters: torch's Adam and optax's form m / (sqrt(v) +
# eps) in other orders, on gradients that agree within 1e-4 of their
# scale; each step moves a parameter by about lr, so a few steps differ by
# a few 1e-5 of lr (tests/test_torch_dist.py's STEP_ATOL, over the steps).
LOSS_RTOL, ABS_ATOL = 1e-4, 1e-4
# Vertices: lr 2e-2 a step on gradients through the soft bins (the arrival
# times' f32 rounding), over a rebuild: within 1e-5 m.
VERT_ATOL = 1e-5


def directions(n, seed=3):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def port_rays(d, source):
    return th.Ray.make(torch.tensor(source).expand(len(d), 3).contiguous(), torch.from_numpy(d))


@pytest.fixture(scope="module")
def group():
    """A gloo group of one for the whole module, as the programs join it."""
    made = join_group(CPU)
    yield
    leave_group(made)


def cfg(**kw):
    return HareConfig(n_rays=N_RAYS, n_bounces=N_BOUNCES, n_bins=N_BINS, **kw)


def test_fit_absorption_loop_matches_jax(group):
    """The concert hall's absorption fit, grid, hard bins: each step's loss
    and the parameters after the steps against the JAX loop's."""
    d = directions(N_RAYS)
    c = cfg()
    prob = fit_absorption.setup(c, False, CPU, rays=port_rays(d, fit_absorption.SOURCE))
    out = fit_absorption.fit(prob, c, ABS_STEPS, CPU, time_iters=0)
    ref = jax_fit_absorption(d, ABS_STEPS, N_BOUNCES, N_BINS)
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(out["params"]["absorption"].numpy(), ref["params"]["absorption"],
                               rtol=0, atol=ABS_ATOL)
    assert out["err"] == pytest.approx(ref["err"], abs=ABS_ATOL)
    assert out["losses"][-1] < out["losses"][0]


def test_fit_vertices_loop_matches_jax(group):
    """The shoebox's vertex fit, soft bins, one rebuild: each step's loss,
    and the vertices and absorption each round hands to the rebuild,
    against the JAX loop's."""
    d = directions(N_RAYS, seed=4)
    c = cfg()
    prob = fit_vertices.setup(c, CPU, rays=port_rays(d, fit_vertices.SOURCE))
    rounds = []
    real_from_indexed = th.Topology.from_indexed

    def spy(points, faces, *a, **k):
        rounds.append(np.asarray(points))
        return real_from_indexed(points, faces, *a, **k)

    try:
        fit_vertices.Topology.from_indexed = spy
        out = fit_vertices.fit(prob, c, VERT_STEPS, VERT_INNER, CPU, time_iters=0)
    finally:
        fit_vertices.Topology.from_indexed = real_from_indexed
    ref = jax_fit_vertices(d, VERT_STEPS, VERT_INNER, N_BOUNCES, N_BINS)
    assert len(rounds) == len(ref["rounds"]) == -(-VERT_STEPS // VERT_INNER)
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=LOSS_RTOL)
    for v, (jv, _) in zip(rounds, ref["rounds"]):
        np.testing.assert_allclose(v, jv, rtol=0, atol=VERT_ATOL)
    np.testing.assert_allclose(out["params"]["absorption"].numpy(), ref["rounds"][-1][1],
                               rtol=0, atol=ABS_ATOL)
    assert out["ext_err"] == pytest.approx(ref["ext_err"], abs=VERT_ATOL)


def test_fit_scattering_resumes_bitwise(group, tmp_path):
    """With --fit-scattering every step draws from a fresh generator of one
    seed: two runs are bitwise equal (determinism_check), and a run
    interrupted at step 2 and resumed from its checkpoint (parameters,
    Adam's state_dict, the generator's state, the cursor) ends bit-equal to
    the uninterrupted run.  Brute force, the quickest plain version here."""
    d = directions(N_RAYS)
    prob = fit_absorption.setup(cfg(accel="brute"), True, CPU,
                                rays=port_rays(d, fit_absorption.SOURCE))
    steps = 4

    def run(c, on_step=None, n=steps):
        return fit_absorption.fit(prob, c, n, CPU, on_step=on_step, time_iters=0)

    assert determinism_check(lambda: run(cfg(accel="brute"), n=2)["params"])
    ref = run(cfg(accel="brute"))
    assert ref["losses"][-1] < ref["losses"][0]
    c = cfg(accel="brute", checkpoint_dir=str(tmp_path / "ck"))

    def fail(i):
        if i == 2:
            raise RuntimeError("injected host failure")

    with pytest.raises(RuntimeError, match="injected"):
        run(c, fail)
    assert latest_step(c.checkpoint_dir) == 0  # saved at steps 0 (and 3, the last)
    resumed = run(c)
    assert resumed["start"] == 1 and len(resumed["losses"]) == steps - 1
    for k, v in ref["params"].items():
        assert torch.equal(v, resumed["params"][k]), k
    assert resumed["losses"] == ref["losses"][1:]
    assert latest_step(c.checkpoint_dir) == steps - 1


@pytest.mark.parametrize("program", ["fit_absorption", "fit_vertices"])
def test_main_end_to_end(group, tmp_path, program, capsys):
    """Each program's main on the CPU at a tiny size: it prints its result
    line, writes its metrics, and (absorption) resumes from its checkpoint."""
    metrics = tmp_path / "m.jsonl"
    argv = ["--device", CPU, "--n-rays", "64", "--n-bounces", "2", "--n-bins", "32",
            "--metrics-path", str(metrics), "--accel", "brute"]
    if program == "fit_absorption":
        ck = str(tmp_path / "ck")
        argv += ["--steps", "3", "--checkpoint-dir", ck]
        err = fit_absorption.main(argv)
        assert 0.0 < err < 1.0 and latest_step(ck) == 2
        fit_absorption.main(argv[:-4] + ["--steps", "4", "--checkpoint-dir", ck])
        out = capsys.readouterr().out
        assert "resumed from step 3" in out and "final mean |a - a_true|" in out
    else:
        argv += ["--steps", "4", "--inner", "2"]
        reduction = fit_vertices.main(argv)
        assert 0.0 < reduction
        assert "reduction" in capsys.readouterr().out
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert lines and all("loss" in x for x in lines)


@pytest.mark.parametrize("program", [fit_absorption, fit_vertices])
def test_main_needs_a_card_unless_told(program):
    """Without a card, the default --device cuda raises; nothing falls back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="--device cpu"):
        program.main(["--steps", "1"])
