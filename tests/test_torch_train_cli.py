"""The port's training CLI against the reference's.

* ``main([..., "--device", "cpu"])`` prints the reference's lines: the same
  header, the same step lines with the numbers in the same places, the
  same ``restored from`` and replica lines (the losses differ: the two
  packages draw their initial params from different generators).
* Cross-package resume: the reference's CLI writes a step-2 checkpoint of
  the reduced qwen2-0.5b; both CLIs resume from copies of it to step 4
  with the same flags.  The losses of steps 2 and 3 agree within rtol
  1e-2, and the step-4 checkpoints leaf by leaf within a bf16 tolerance:
  the largest difference at most 1e-2 of the leaf's largest magnitude for
  the bf16 params (measured on the CPU: 0.79% at most) and 3e-2 for the f32
  momentum (1.81% at most), which holds the bf16 model's gradients of two
  steps.  bf16 rounds at other places in the two frameworks; in f32 the
  same loop agrees to 1.5e-7 (``test_torch_checkpoint.py``), so what
  differs here is rounding, not the algorithm.
* Without ``--device`` on a host without a card the CLI raises.
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro_torch.launch import train as ttrain

ARGS = ["--arch", "qwen2-0.5b", "--batch", "2", "--seq", "16",
        "--log-every", "1", "--div-max", "5", "--ckpt-every", "2"]


def _shape(line):
    return re.sub(r"\d+(\.\d+)?(e[-+]\d+)?", "#", line).split("(")[0]


def test_cli_prints_the_reference_lines(tmp_path, capsys):
    argv = ARGS + ["--steps", "3"]
    jtrain.main(argv + ["--ckpt-dir", str(tmp_path / "j")])
    jout = capsys.readouterr().out.splitlines()
    assert ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "t"),
                               "--device", "cpu"]) == 0
    tout = capsys.readouterr().out.splitlines()
    assert tout[0] == jout[0]        # arch, params, steps, lr
    assert [_shape(l) for l in tout] == [_shape(l) for l in jout]
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j")) == \
        ["step_0000000002", "step_0000000003"]
    # a resume prints the reference's "restored from" line
    ttrain.main(ARGS + ["--steps", "4", "--ckpt-dir", str(tmp_path / "t"),
                        "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "restored from step 3"
    assert lines[2].startswith("step     3  loss ")
    assert lines[-1].startswith("replica syncs=")


def test_cli_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--steps", "1"])


def test_cli_run_returns_its_record(tmp_path, capsys):
    run = ttrain.train(ARGS + ["--steps", "2", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path)])
    capsys.readouterr()
    assert len(run.losses) == len(run.step_seconds) == 2
    assert np.isfinite(run.losses).all()
    assert len(run.save_seconds) == 1         # step 2, saved once
    assert run.replica.syncs >= 1 and run.start_step == 0


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_cross_package_resume(tmp_path, capsys):
    """The reference writes step 2; both CLIs resume from it to step 4."""
    base = ARGS + ["--schedule", "cosine"]
    jtrain.main(base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "j")])
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    jtrain.main(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "j")])
    ttrain.main(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "t"),
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("restored from step 2") == 2
    # the losses of steps 2 and 3, reference's run first
    losses = [float(x) for x in re.findall(r"step +[23]  loss (\S+)", out)]
    assert len(losses) == 4
    np.testing.assert_allclose(losses[2:], losses[:2], rtol=1e-2)
    step4 = "step_0000000004"
    for name, limit in (("params.npz", 1e-2), ("opt.npz", 3e-2)):
        j = _load(tmp_path / "j" / step4 / name)
        t = _load(tmp_path / "t" / step4 / name)
        assert t.keys() == j.keys()
        for k in j:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape
            gap = np.abs(t[k] - j[k]).max() / np.abs(j[k]).max()
            assert gap <= limit, (name, k, gap)
    with open(tmp_path / "t" / step4 / "meta.json") as f:
        tmeta = f.read()
    with open(tmp_path / "j" / step4 / "meta.json") as f:
        jmeta = f.read()
    assert re.sub(r'"time": [\d.]+', "", tmeta) == \
        re.sub(r'"time": [\d.]+', "", jmeta)
