"""The harness end to end on the CPU, at the cut size (the program's
``ModelConfig.reduced()`` rule, sequence 256 x 2 rows), the kernels on
their plain routes.  The program runs in float32 here, so that its
readings against the reference are round-off and the limits the chip set
hold with room; every cell must come out ``correct``, and come out not
correct with the control in the program's place and with each fault
planted in the program's timed path.

    python -m pytest -q portbench/test_portbench_harness.py
"""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import faults, harness, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
CUT = {"seq_len": 256, "rows": 2}


def _run(cell, **kw):
    torch.set_num_threads(4)
    return harness.run_cell(cell, 20260 + len(cell), 1.0, kw.pop("trace",
                                                                  False),
                            device=torch.device("cpu"),
                            t_start=time.perf_counter(),
                            sizes_fn=spec.reduced_sizes, traffic_over=CUT,
                            dtype=torch.float32, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == set(spec.metrics_for(cell, False))
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= out["updates"]["window"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("what", ("control",) + faults.FAULTS)
def test_broken_run_is_not_correct(cell, what):
    with faults.planted(None if what == "control" else what):
        out = _run(cell, control=what == "control")
    assert not out["correct"], out["checks"]


def test_traced_run_reports_its_per_layer_metrics():
    cell = "granite_moe_1b.async4.s4096_b2"
    out = _run(cell, trace=True)
    assert out["correct"]
    # on the CPU no device operation runs: the device readers read nothing
    # but the idle share, and the host and FLOP ones read
    assert {"mfu", "device_idle_share", "control_plane_ms"} <= \
        set(out["metrics"])
    assert set(out["metrics"]) <= set(spec.metrics_for(cell, True))
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _copy_bench(tmp_path, with_src=True):
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    if with_src:
        os.symlink(spec.ROOT / "src", root / "src")
    return root


def _py(root, code):
    env = dict(os.environ, PYTHONPATH=f"{root}:{root}/src")
    return subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env=env)


def test_new_config_traffic_and_metric_are_files_only(tmp_path):
    """A cell, configuration, traffic mix and per-layer metric that later
    work adds: new files and new entries, no edit to an existing file."""
    root = _copy_bench(tmp_path)
    b = json.loads((root / "BENCHMARK.json").read_text())
    conf = json.loads((root / "portbench/configs/granite_moe_1b.json")
                      .read_text())
    conf["num_hidden_layers"] = 2
    (root / "portbench/configs/granite_2l.json").write_text(json.dumps(conf))
    t = json.loads((root / "portbench/traffic/step_int8.s4096_b2.json")
                   .read_text())
    t.update(seq_len=256)
    (root / "portbench/traffic/step_int8.s256_b2.json").write_text(
        json.dumps(t))
    (root / "portbench/workloads/granite_2l.step_int8.s256_b2.json"
     ).write_text(json.dumps({"limits": {"loss": 1e-3, "grad": 1e-3,
                                         "change": 1e-3}}))
    (root / "portbench/layers/steps_per_s.py").write_text(
        "def read(ctx):\n    return ctx.updates / ctx.window_s\n")
    b["configs"].append(dict(b["configs"][1], name="granite_2l",
                             file="portbench/configs/granite_2l.json",
                             reduced=b["configs"][1]["reduced"]
                             + ["num_hidden_layers"]))
    b["workloads"].append({"name": "granite_2l.step_int8.s256_b2",
                           "config": "granite_2l",
                           "traffic": "step_int8.s256_b2", "chips": 1,
                           "why": "a test cell"})
    b["per_layer"].append({"name": "steps_per_s", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "whole step",
                           "moves": "train_tokens_per_s",
                           "workloads": ["granite_2l.step_int8.s256_b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    r = _py(root, (
        "import time, torch\n"
        "from portbench import harness, spec\n"
        "torch.set_num_threads(4)\n"
        "out = harness.run_cell('granite_2l.step_int8.s256_b2', 5, 0.5, "
        "True, device=torch.device('cpu'), t_start=time.perf_counter(), "
        "sizes_fn=spec.reduced_sizes, dtype=torch.float32)\n"
        "print(out['correct'], sorted(out['metrics']))\n"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "True" in r.stdout and "steps_per_s" in r.stdout, r.stdout


def test_cli_refuses_without_a_card(tmp_path):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "3000000001", "--seconds", "1"],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_cli_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    root = _copy_bench(tmp_path, with_src=False)
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
