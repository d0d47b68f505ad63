"""`BENCHMARK.json` against the benchmark's contract, and the harness's
finding of every file by name."""

import json
import re
from pathlib import Path

import pytest

from harness import manifest

BENCH = Path(manifest.HERE)
ROOT = BENCH.parent
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
ONE_LINE = re.compile(r"[^\t\n\r]{1,200}")


@pytest.fixture(scope="module")
def spec():
    return manifest.load_manifest()


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"][:2] == ["python3", "benchmark/run.py"] and len(spec["command"]) <= 32
    assert spec["paths"] == ["benchmark"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) <= 64 * 1024


def test_names_units_and_lines(spec):
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]]
    metrics = spec["end_to_end"] + spec["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w["traffic"] for w in spec["workloads"]] + [w["config"] for w in spec["workloads"]]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    for name in names:
        assert manifest.NAME.fullmatch(name), name
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({w["name"] for w in spec["workloads"]}) == len(spec["workloads"])
    for m in metrics:
        assert manifest.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for text in ([w["why"] for w in spec["workloads"]] + [c["why"] for c in spec["configs"]]
                 + [c["source"] for c in spec["configs"]] + [m["layer"] for m in spec["per_layer"]]
                 + spec["command"]):
        assert ONE_LINE.fullmatch(text), text


def test_entries_have_only_their_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(spec):
    """setup_s, another end-to-end metric and a per-layer one, each per-layer
    metric only where its end-to-end metric is reported."""
    for w in spec["workloads"]:
        cell = manifest.cell(w["name"], spec)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}


def test_every_file_is_found_by_name(spec):
    for w in spec["workloads"]:
        cell = manifest.cell(w["name"], spec)
        assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
        assert set(cell.readers) == {m["name"] for m in cell.end_to_end + cell.per_layer}
        assert all(callable(r) for r in cell.readers.values())
        assert set(cell.config["check"]["limits"]) <= {
            "iters_gap", "time_gap", "len_gap", "path_gap", "clearance", "pair_clearance"}


def test_file_names_use_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        for part in path.relative_to(ROOT).parts:
            assert re.fullmatch(r"[A-Za-z0-9_.\-]+", part), path


def test_a_new_cell_needs_only_new_files(tmp_path, spec):
    """A cell, a configuration, a mix and a metric added as files and
    manifest entries are found without an edit to any file that exists."""
    for kind in ("configs", "traffic", "layers", "metrics"):
        (tmp_path / kind).mkdir()
    config = json.loads((BENCH / "configs" / "bridge_p4.json").read_text())
    config["n_pieces"] = 8
    (tmp_path / "configs" / "bridge_p8.json").write_text(json.dumps(config))
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps({"pool": 4, "trace_plans": 1}))
    (tmp_path / "metrics" / "plans_per_s.py").write_text((BENCH / "metrics" / "plans_per_s.py")
                                                        .read_text())
    (tmp_path / "metrics" / "setup_s.py").write_text((BENCH / "metrics" / "setup_s.py").read_text())
    (tmp_path / "layers" / "plans_seen.py").write_text("def read(ctx):\n    return len(ctx.answers)\n")
    extra = dict(spec)
    extra["workloads"] = [{"name": "bridge_p8.burst", "config": "bridge_p8", "traffic": "burst",
                           "chips": 1, "why": "a fixture"}]
    extra["end_to_end"] = [m for m in spec["end_to_end"] if m["name"] in ("plans_per_s", "setup_s")]
    extra["end_to_end"][0] = dict(extra["end_to_end"][0], workloads=["bridge_p8.burst"])
    extra["per_layer"] = [{"name": "plans_seen", "unit": "plans", "better": "higher",
                           "source": "program_counter", "layer": "a fixture",
                           "moves": "plans_per_s"}]
    cell = manifest.cell("bridge_p8.burst", extra, base=tmp_path)
    assert cell.config["n_pieces"] == 8 and cell.traffic["pool"] == 4
    assert cell.readers["plans_seen"](type("Ctx", (), {"answers": [1, 2]})) == 2
    assert {m["name"] for m in cell.end_to_end} == {"plans_per_s", "setup_s"}
