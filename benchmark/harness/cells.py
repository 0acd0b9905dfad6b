"""Everything a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell names
a configuration (``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``), which names its driver, the loop
and the entry point's adapter (``benchmark/drivers/<driver>.py``, see
``harness.drive``); its comparison's limits are
``benchmark/limits/<cell>.json``; each metric is read by
``benchmark/metrics/<metric>.py``'s ``read(run)``, which returns a number or
None (nothing to read in this run).  A configuration names its plain
reference, ``benchmark/reference/<reference>.py``.  Adding any of these is
adding a file and an entry; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def limits(cell: str) -> dict:
    return _json("limits", cell)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a cell reports: its per-layer ones in a traced
    run, its end-to-end ones otherwise (an entry without ``workloads``
    belongs to every cell)."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def _module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path.relative_to(ROOT)}")
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``benchmark/metrics/<name>.py``'s ``read``."""
    return _module("metrics", name).read


def driver(name: str):
    """``benchmark/drivers/<name>.py``: its ``make`` and ``run``."""
    return _module("drivers", name)


def reference(name: str):
    """The plain reference module of a configuration's chain."""
    return importlib.import_module(f"reference.{name}")
