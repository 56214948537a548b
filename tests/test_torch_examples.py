"""``examples_torch/``: the PyTorch port's twins of the nine
``examples/*.py``, each run as a user runs it, on the CPU
(``--device cpu``) with the reference's fast flags
(``tests/test_examples_smoke.py``).

* The twins are the examples, name for name.
* Each twin exits 0 and prints.  All nine start at once, each in one
  subprocess, beside the JAX references they are held against.
* The four control-plane twins (``quickstart``, ``dynamic_cluster``,
  ``bottleneck_report``, ``lossy_network``) print the reference's lines,
  every one (``lossy_network``'s error-feedback figures run on tensors in
  the port).
* The tensor twins print the reference's control-plane counts: the
  recovery table, and the real-tensor kill's commits, replicated commits,
  promotions, recovery time and regenerated updates (``failover``); the
  commits, simulated seconds, largest delay and drops of each trainer
  (``async_vs_sync``, ``lda_topic_model``: the reference's trainers run
  here on a 4-element quadratic with the example's control-plane
  settings, as its own example takes over a minute to compile); the
  prompts (``serve_decode``); the Div_max sweep (``bounded_replication``).
  Excepted, as they come from tensor values: the losses and held-out
  log-likelihoods (``torch`` draws the params; LDA starts from zeros but
  its lr 5.0 carries one-ulp differences into the third digit after 20
  commits), the generated tokens, the replica's syncs, savings,
  promotion step and drift (the update norms it reads), the final loss
  of the kill, and wall-clock figures (masked: the failover record
  line's microseconds).
"""

import glob
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST_ARGS = {
    "quickstart.py": [],
    "dynamic_cluster.py": [],
    "bounded_replication.py": [],
    "failover.py": [],
    "async_vs_sync.py": ["--quick"],
    "bottleneck_report.py": ["--quick"],
    "lda_topic_model.py": ["--quick"],
    "lossy_network.py": [],
    "serve_decode.py": ["--batch", "1", "--prompt-len", "8",
                        "--new-tokens", "4"],
}
CONTROL_PLANE = ["quickstart.py", "dynamic_cluster.py",
                 "bottleneck_report.py", "lossy_network.py"]
# the reference examples run beside the twins (the rest are compared
# through the reference's trainers, or not at all)
REFERENCE_RUNS = CONTROL_PLANE + ["failover.py", "serve_decode.py"]
# the one wall-clock figure the compared lines print: the benchmark record
# line's microseconds
WALL_CLOCK = re.compile(r"failover_recovery,\d+")


def _start(path, args, cwd):
    # one thread a process: the fifteen processes share the host's cores
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    return subprocess.Popen([sys.executable, path, *args], cwd=cwd, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (exit code, stdout, stderr)} of every twin and of the
    references in ``REFERENCE_RUNS``, all run at once (the twins write
    what they write under their own working directory)."""
    cwd = str(tmp_path_factory.mktemp("examples"))
    procs = {("port", n): _start(os.path.join(REPO, "examples_torch", n),
                                 FAST_ARGS[n] + ["--device", "cpu"], cwd)
             for n in FAST_ARGS}
    ref_cwd = str(tmp_path_factory.mktemp("examples_ref"))
    procs.update({("ref", n): _start(os.path.join(REPO, "examples", n),
                                     FAST_ARGS[n], ref_cwd)
                  for n in REFERENCE_RUNS})
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            out[key] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _lines(text):
    return [WALL_CLOCK.sub("<t>", line) for line in text.splitlines()]


def test_every_example_has_a_twin():
    names = lambda d: sorted(  # noqa: E731
        os.path.basename(p) for p in glob.glob(os.path.join(REPO, d,
                                                            "*.py")))
    assert names("examples_torch") == names("examples") == sorted(FAST_ARGS)


@pytest.mark.parametrize("name", sorted(FAST_ARGS))
def test_twin_runs_clean(runs, name):
    rc, stdout, stderr = runs[("port", name)]
    assert rc == 0, f"{name} exited {rc}\n{stderr[-3000:]}"
    assert stdout.strip(), f"{name} printed nothing"


@pytest.mark.parametrize("name", CONTROL_PLANE)
def test_control_plane_twin_prints_the_reference(runs, name):
    ref = runs[("ref", name)]
    assert ref[0] == 0, ref[2][-3000:]
    assert _lines(runs[("port", name)][1]) == _lines(ref[1])


def test_failover_counts_match(runs):
    port, ref = runs[("port", "failover.py")][1], runs[("ref",
                                                        "failover.py")][1]
    # every line but the final loss's, wall clock masked
    keep = lambda t: [l for l in _lines(t)  # noqa: E731
                      if not l.startswith("final loss")]
    assert keep(port) == keep(ref)
    assert "1 promotion" in port


def test_serve_decode_prompts_match(runs):
    port, ref = runs[("port", "serve_decode.py")][1], runs[(
        "ref", "serve_decode.py")][1]
    head = lambda t: [l.split("->")[0] if "->" in l  # noqa: E731
                      else l.split(" steps in ")[0] for l in t.splitlines()]
    assert head(port) == head(ref)


def test_bounded_replication_sweeps_div_max(runs):
    lines = runs[("port", "bounded_replication.py")][1].splitlines()
    assert [float(l.split()[0]) for l in lines[1:6]] == [0.01, 0.5, 2.0,
                                                         8.0, 32.0]
    assert any(l.startswith("primary failed at step 39") for l in lines)


def _reference_trainer_rows(straggler, variants, commits, **kw):
    """The reference's ``AsyncTrainer`` with the example's control-plane
    settings on a 4-element quadratic: (commits, simulated seconds,
    largest delay, drops) a variant."""
    import jax.numpy as jnp
    from repro.ps import AsyncTrainer

    def loss(p, b):
        return jnp.sum(jnp.square(p["w"] - 1.0))

    rows = []
    for tau, aggs in variants:
        res = AsyncTrainer({"w": jnp.zeros(4)}, loss, lambda w, t: {},
                           n_workers=8, tau_max=tau, straggler=straggler,
                           aggregators=aggs, **kw
                           ).run(until_commits=commits)
        rows.append((res.commits, f"{res.sim_time:.1f}",
                     f"{res.delay_stats['max']:.0f}", res.drops))
    return rows


def test_async_vs_sync_counts_match_the_reference(runs):
    from repro.core import C1, C2, N_STATIC, mb
    from repro.core.baselines import SyncSim
    got = [l.split() for l in runs[("port", "async_vs_sync.py")][1]
           .splitlines()[1:]]
    want = []
    for straggler in (C1, C2):
        for tau in (30, None):
            (c, t, d, dr), = _reference_trainer_rows(
                straggler, [(tau, 2 if tau else 0)], 60, base_lr=0.4,
                gamma=0.0, delay_adaptive=tau is not None,
                update_size=mb(20), compute_time=0.05, bandwidth=N_STATIC,
                seed=1)
            want.append((str(c), t, d, str(dr)))
        sync = SyncSim(8, update_size=mb(20), compute_time=0.05,
                       straggler=straggler, seed=1).run(60 // 8)
        want.append(("60", f"{sync.total_time:.1f}", "0", "0"))
    # commits, time, max delay, drops: the last 4 columns but the loss
    assert [(r[-5], r[-4], r[-2], r[-1]) for r in got] == want


def test_lda_counts_match_the_reference(runs):
    from repro.core import C1, N_STATIC, mb
    got = [l.split() for l in runs[("port", "lda_topic_model.py")][1]
           .splitlines()[1:]]
    want = _reference_trainer_rows(
        C1, [(30, 2), (60, 2), (None, 0)], 80, base_lr=5.0, gamma=0.0,
        delay_adaptive=False, update_size=mb(50), compute_time=0.18,
        bandwidth=N_STATIC, seed=2)
    # commits, time, max delay (the log-likelihood excepted)
    assert [(int(r[-4]), r[-3], r[-1]) for r in got] == [
        (c, t, d) for c, t, d, _ in want]
