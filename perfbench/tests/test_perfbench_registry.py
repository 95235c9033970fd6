"""The registry finds every piece by name, and a new file is picked up
without an edit of any file that is there."""
import json
import os
import shutil

from conftest import ROOT
from harness import runner, spec
from reference import check


def test_every_named_file_exists_and_loads():
    b = spec.benchmark()
    assert b["paths"] == ["perfbench"]
    for c in b["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert os.path.isfile(os.path.join(ROOT, cfg["policy"]))
    for w in b["workloads"]:
        cell = spec.cell(w["name"])
        prog_side = spec.entry(cell.traffic["entry"])
        ref_side = check.entry(cell.traffic["entry"])
        assert all(callable(getattr(prog_side, f)) for f in
                   ("build", "unit", "record", "span_targets", "unit_flops"))
        assert callable(ref_side.follow) and callable(ref_side.compare)
        assert ref_side.CONTROL and ref_side.FAULTS
        assert {m.name for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(spec.readers(cell)) == {m.name for m in cell.per_layer}
    for m in b["per_layer"]:
        assert os.path.isfile(spec.metric_path(m["name"]))


def test_new_files_are_found_without_edits(tmp_path):
    """A copy of the tree with one more traffic mix driving a new entry (its
    program and reference sides as new files), limits file, metric and cell
    entry: the new cell, entry and metric are found by name, and the cell
    runs whole on the CPU at a tiny size."""
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = spec.benchmark()
    b["workloads"].append({"name": "hover.collect", "config": "aw109-hover",
                           "traffic": "collect2", "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "extra_ms.collect2", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "device",
                           "moves": "collect_env_steps_per_s",
                           "workloads": ["hover.collect"]})
    b["end_to_end"][1]["workloads"].append("hover.collect")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    pb = tmp_path / "perfbench"
    (pb / "traffic" / "collect2.json").write_text(json.dumps({"entry": "collect2",
                                                              "compared_units": 1}))
    shutil.copy(pb / "entries" / "collect.py", pb / "entries" / "collect2.py")
    shutil.copy(pb / "reference" / "entries" / "collect.py",
                pb / "reference" / "entries" / "collect2.py")
    (pb / "limits" / "hover.collect.json").write_text(json.dumps({"rollout_gap": 1.0}))
    (pb / "metrics" / "extra_ms.collect2.py").write_text("def read(ctx):\n    return 1.5\n")
    cell = spec.cell("hover.collect", root=str(tmp_path))
    assert cell.traffic["compared_units"] == 1 and cell.limits == {"rollout_gap": 1.0}
    assert [m.name for m in cell.end_to_end] == ["collect_env_steps_per_s", "setup_s"]
    readers = spec.readers(cell)
    assert set(readers) == {"extra_ms.collect2"}
    assert readers["extra_ms.collect2"](None) == 1.5
    assert spec.entry("collect2", str(pb)).__file__ == str(pb / "entries" / "collect2.py")
    res = runner.run(cell, 5, 0.1, True, "cpu", 0.0,
                     overrides={"num_envs": 8, "rollout_steps": 3}, log=lambda m: None)
    assert res["correct"] is True and res["metrics"]["extra_ms.collect2"]["value"] == 1.5
