"""`BENCHMARK.json` against the files it names: every configuration,
traffic mix and metric reader is a file of its own, found by name."""
import json
import re
from pathlib import Path

import pytest

from simbench import harness
from simbench.run import cell_metrics

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    config = json.loads((ROOT / entry["file"]).read_text())
    assert config["source"] == entry["source"]
    assert set(entry["reduced"]) == set(config["published"])
    for key in entry["reduced"]:
        assert config[key] != config["published"][key]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells(cell):
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4)
    assert any(c["name"] == cell["config"] for c in BENCH["configs"])
    traffic = json.loads((ROOT / "simbench" / "traffic" /
                          f"{cell['traffic']}.json").read_text())
    harness.check_traffic(traffic)
    for trace in (False, True):
        assert cell_metrics(BENCH, cell["name"], trace)
    assert "setup_s" in cell_metrics(BENCH, cell["name"], False)


def test_metrics_have_readers():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for name in names:
        assert NAME.match(name)
        assert (ROOT / "simbench" / "metrics" / f"{name}.py").exists()
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert any(e["name"] == m["moves"] for e in BENCH["end_to_end"])
