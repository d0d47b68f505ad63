"""`BENCHMARK.json` and the files it names, found by name.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); an end-to-end metric is read by
``metrics/<metric>.py`` and a per-layer one by ``layers/<metric>.py``, each
a ``read(ctx)`` that returns a number, or None where it finds nothing to
read (the metric is then left out of the result).  Adding a cell, a configuration, a mix or a metric
takes new files and manifest entries only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # the benchmark's folder
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict            # configs/<config>.json, with its "name"
    traffic: dict           # traffic/<traffic>.json, with its "name"
    end_to_end: list        # the manifest's entries this cell reports
    per_layer: list
    readers: dict           # metric name -> its read(ctx) function


def manifest_path(root: Path | None = None) -> Path:
    return (root or HERE.parent) / "BENCHMARK.json"


def load_manifest(path: Path | None = None) -> dict:
    with open(path or manifest_path()) as f:
        return json.load(f)


def _json(kind: str, name: str, base: Path) -> dict:
    with open(base / kind / f"{name}.json") as f:
        data = json.load(f)
    data["name"] = name
    return data


def _in_cell(metric: dict, cell: str, reported: set) -> bool:
    """A metric with ``workloads`` is in the cells it lists; a per-layer one
    without it, in every cell that reports the end-to-end metric it moves;
    an end-to-end one without it, in every cell."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in reported
    return True


def load_reader(kind: str, name: str, base: Path = HERE):
    """``<kind>/<name>.py``'s ``read`` function (kind "metrics" or "layers")."""
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell(name: str, manifest: dict | None = None, base: Path = HERE,
         unlisted: bool = False) -> Cell:
    """The cell ``name`` of the manifest, with its files loaded.  With
    ``unlisted``, a name ``<config>.<traffic>`` that the manifest does not
    list is the cell of those two files on one chip, with the metrics that
    name no cells (for a CPU rehearsal and for `readings`)."""
    manifest = manifest or load_manifest()
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None and unlisted and "." in name:
        config, traffic = name.split(".", 1)
        entry = {"name": name, "config": config, "traffic": traffic, "chips": 1}
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in manifest["end_to_end"] if _in_cell(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _in_cell(m, name, names)]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_json("configs", entry["config"], base),
                traffic=_json("traffic", entry["traffic"], base),
                end_to_end=e2e, per_layer=per_layer,
                readers={**{m["name"]: load_reader("metrics", m["name"], base) for m in e2e},
                         **{m["name"]: load_reader("layers", m["name"], base) for m in per_layer}})
