"""The frozen inputs: the scenes and the ray generator hold their digests,
and the frozen shapes equal the port's generators they were copied from
(a change there must not move the benchmark's scenes unseen)."""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from raybench import rays, shapes  # noqa: E402

DIGESTS = json.loads((ROOT / "raybench" / "digests.json").read_text())


def _digest(chunks) -> str:
    h = hashlib.sha256()
    for c in chunks:
        h.update(np.ascontiguousarray(c, np.float64).tobytes())
    return h.hexdigest()


CONFIGS = ["eval3_hall_octree", "eval4_shell650k_kdtree", "eval5_shell5m_grid256"]


@pytest.mark.parametrize("config", CONFIGS)
def test_scene_digest(config):
    cfg = json.loads((ROOT / "raybench" / "configs" / f"{config}.json").read_text())
    chunks = shapes.scene(cfg["scene"])
    assert sum(len(c) for c in chunks) == cfg["n_triangles"] == DIGESTS[config]["n_faces"]
    assert _digest(chunks) == DIGESTS[config]["faces_sha256"]


def test_ray_pool_digest():
    d = DIGESTS["ray_pool"]
    pool = rays.pool(d["seed"], d["rays"], d["batches"], d["device"])
    h = hashlib.sha256()
    for x in pool:
        h.update(x.numpy().tobytes())
    assert h.hexdigest() == d["sha256"]
    norms = np.linalg.norm(pool[0].numpy().astype(np.float64), axis=1)
    assert np.abs(norms - 1).max() < 1e-6


def test_seed_sets_the_pool():
    a = rays.pool(2**31 + 11, 64, 2, "cpu")
    b = rays.pool(2**31 + 11, 64, 2, "cpu")
    c = rays.pool(2**31 + 12, 64, 2, "cpu")
    assert all(bool((x == y).all()) for x, y in zip(a, b))
    assert not bool((a[0] == c[0]).all())
    assert not bool((a[0] == a[1]).all())
    s = rays.sample(2**33 + 5, 1000, 100)
    assert len(set(s.tolist())) == 100 and bool((s[1:] > s[:-1]).all())


@pytest.mark.parametrize("shape,args,port", [
    ("shoebox", {"lx": 40.0, "ly": 40.0, "lz": 40.0}, lambda s: s.shoebox(40.0, 40.0, 40.0)),
    ("icosphere", {"subdiv": 4, "radius": 6.0, "center": [10.0, 30.0, 14.0]},
     lambda s: s.icosphere(4, radius=6.0, center=(10.0, 30.0, 14.0))),
    ("concert_hall", {"seed": 1}, lambda s: s.concert_hall()),
])
def test_frozen_shapes_equal_the_ports(shape, args, port):
    from hare_tpu_torch.mesh import shapes as port_shapes

    assert np.array_equal(shapes.faces(shape, args), np.stack(port(port_shapes)))


def test_scene_equals_the_ports_configuration():
    """Eval config 4's ``big_scene("650k")``, as the port's
    ``benchmarks/configs.py`` builds it."""
    from hare_tpu_torch.benchmarks.configs import big_scene

    cfg = json.loads((ROOT / "raybench" / "configs" / "eval4_shell650k_kdtree.json").read_text())
    ours = np.concatenate(shapes.scene(cfg["scene"]))
    assert np.array_equal(ours, np.concatenate(big_scene("650k")))
