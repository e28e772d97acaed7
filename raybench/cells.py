"""A cell of ``BENCHMARK.json``, resolved by name into its files: the
configuration (``file``), the traffic mix (``traffic/<traffic>.json``), the
limits of its check (``limits/<cell>.json``) and the reader of each of its
metrics (``metrics/<metric>.py``).  Adding a cell, a configuration, a
traffic mix or a metric adds files; nothing here names one.

A traffic mix may say what the step is differentiated in and through what
(``histogram``, ``loss``, ``wrt``, ``remat``); :func:`step_of` reads them,
each absent key at the step every cell took before these keys.

A metric split by the cells' family, ``<metric>.<family>`` (one bound for
cells the device paces, another for cells the host paces), is the same
quantity: where it has no reader of its own, ``<metric>``'s reads it."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple

HERE = Path(__file__).resolve().parent


class Step(NamedTuple):
    """What a step computes after the trace: soft or hard bins, the first
    moment or the sum as the loss, the gradient w.r.t. the vertices or the
    absorption, and per-bounce remat."""

    soft: bool
    first_moment: bool
    wrt_vertices: bool
    remat: bool


_CHOICES = {"histogram": {"hard": False, "soft": True},
            # The first three traffic files spell the sum out.
            "loss": {"sum": False, "sum of the hard histogram": False, "first_moment": True},
            "wrt": {"absorption": False, "vertices": True},
            "remat": {False: False, True: True}}
_DEFAULTS = {"histogram": "hard", "loss": "sum", "wrt": "absorption", "remat": False}


def step_of(traffic: Dict) -> Step:
    """The traffic mix's step; raises on a value it does not know."""
    got = {}
    for key, table in _CHOICES.items():
        value = traffic.get(key, _DEFAULTS[key])
        if value not in table:
            raise ValueError(f"traffic key {key!r}: {value!r} is not one of {list(table)}")
        got[key] = table[value]
    return Step(got["histogram"], got["loss"], got["wrt"], got["remat"])


class Metric(NamedTuple):
    name: str
    unit: str
    read: Callable  # read(ctx) -> float or None
    # The reader's DEVICE_WINDOW: an end-to-end metric that reads the
    # device's operations over the whole measured window.
    device_window: bool = False


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _reader(name: str, base: Path):
    path = base / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = base / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"raybench_metric_{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} under {base / 'metrics'}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metrics(entries: List[Dict], cell: str, base: Path) -> List[Metric]:
    got = []
    for m in entries:
        if cell in m.get("workloads", [cell]):
            mod = _reader(m["name"], base)
            got.append(Metric(m["name"], m["unit"], mod.read,
                              bool(getattr(mod, "DEVICE_WINDOW", False))))
    return got


def resolve(name: str, root: Path = HERE.parent, base: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, its files under
    ``base``."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(root / configs[w["config"]]["file"])
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=cfg,
        traffic=_json(base / "traffic" / f"{w['traffic']}.json"),
        limits=_json(base / "limits" / f"{name}.json"),
        end_to_end=_metrics(bench["end_to_end"], name, base),
        per_layer=_metrics(bench["per_layer"], name, base),
    )
