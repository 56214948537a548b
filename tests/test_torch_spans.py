"""The port's own spans and counters on the profiler's clock
(``repro_torch.obs.region`` and ``RUNTIME``).

Without a profiler a region is one shared no-op and nothing is counted;
under a CPU ``torch.profiler`` a tiny unsharded MLfabric step and a tiny
MLfabric-A run leave the same params as without one, and the exported
Chrome trace holds every ``mlfabric.*`` span, each inside the parent it
belongs to, with the ids its root carries; the MoE's slot counters equal
the sums of the dispatch one-hots.
"""

import json
import re

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import build_step, make_host_mesh
from repro_torch.models import build_model, moe
from repro_torch.models.api import value_and_grad
from repro_torch.obs import RUNTIME, recording, region
from repro_torch.optim import momentum_sgd_init
from repro_torch.ps import AsyncTrainer
from repro_torch.tree import tree_leaves

CFG = get_config("granite-moe-1b-a400m").reduced()
SEQ, ROWS = 64, 2

# kind -> the kinds its parent may be (None: a root)
PARENTS = {
    "step": {None}, "fwd_bwd": {"step", "compute"},
    "forward": {"fwd_bwd"}, "backward": {"fwd_bwd"},
    "attention": {"forward", "backward"}, "moe": {"forward", "backward"},
    "pack": {"step"}, "reduce": {"step"}, "bucket": {"reduce"},
    "unpack": {"step"}, "update": {"step", "commit"},
    "run": {None}, "plan": {"run"}, "compute": {"run"},
    "data": {"compute"}, "wire": {"compute"},
    "sync": {"compute", "wire"}, "commit": {"run"},
}
# kind -> the args its name carries
ARGS = {"step": ["step"], "attention": ["layer"], "moe": ["layer"],
        "bucket": ["bucket", "bytes"], "plan": ["batch", "updates"],
        "compute": ["worker", "version", "t"], "wire": ["floats"],
        "sync": ["read"], "commit": ["uid", "worker", "version"]}


@pytest.fixture(autouse=True)
def _fresh_counters():
    RUNTIME.clear()
    yield
    RUNTIME.clear()


def _batch(k):
    g = torch.Generator().manual_seed(k)
    t = torch.randint(0, CFG.vocab_size, (ROWS, SEQ), generator=g)
    return {"tokens": t, "labels": torch.roll(t, -1, 1)}


def _params():
    model = build_model(CFG, dtype=torch.float32, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _step_and_trainer():
    """Params after two donated MLfabric steps, and after four commits of
    MLfabric-A from them."""
    model, params = _params()
    step = build_step(CFG, ShapeConfig("t", SEQ, ROWS, "train"),
                      make_host_mesh(device="cpu"), grad_path="mlfabric",
                      compress_inter=True, bucket_bytes=2 ** 18).donating()
    opt = momentum_sgd_init(params)
    for k in range(2):
        params, opt, _ = step(params, opt, _batch(k))
    stepped = [p.clone() for p in tree_leaves(params)]
    tr = AsyncTrainer(params, model.loss_fn, lambda w, t: _batch(100 + t),
                      n_workers=2, tau_max=4, compress=True, has_aux=True,
                      delay_adaptive=False, base_lr=0.1, device="cpu")
    tr.run(until_commits=4)
    return stepped, [p.clone() for p in tree_leaves(tr.server.params)]


def _profiled(fn, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["tid"], e["ts"], e["ts"] + e["dur"], e["name"])
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e["name"].startswith("mlfabric.")]
    return out, spans


def _kind(name):
    return name[len("mlfabric."):].split(" ", 1)[0]


def _parent(span, spans):
    """The innermost other span on the same thread that holds ``span``."""
    tid, a, b, _ = span
    holders = [s for s in spans if s is not span and s[0] == tid
               and s[1] <= a and b <= s[2]]
    return min(holders, key=lambda s: s[2] - s[1], default=None)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """(params without a profiler, params under one, the trace's spans)."""
    plain = _step_and_trainer()
    RUNTIME.clear()
    profiled, spans = _profiled(_step_and_trainer,
                                tmp_path_factory.mktemp("trace"))
    return plain, profiled, spans


def test_region_is_one_shared_no_op_without_a_profiler():
    assert not recording()
    a, b = region("mlfabric.step", step=3), region("mlfabric.moe")
    assert a is b
    with a as got:
        assert got is None


def test_nothing_is_counted_without_a_profiler():
    model, params = _params()
    value_and_grad(model.loss_fn, params, _batch(0), has_aux=True)
    assert RUNTIME.names() == []


def test_region_names_its_args_under_a_profiler(tmp_path):
    def fn():
        assert recording()
        with region("mlfabric.commit", uid=7, worker="worker1", version=2):
            torch.ones(2).sum()
    _, spans = _profiled(fn, tmp_path)
    assert [s[3] for s in spans] == \
        ["mlfabric.commit uid=7 worker=worker1 version=2"]


@pytest.mark.parametrize("which", ["step", "async"])
def test_spans_change_no_bit(traced, which):
    plain, profiled, _ = traced
    i = ["step", "async"].index(which)
    assert len(plain[i]) == len(profiled[i]) > 0
    for a, b in zip(plain[i], profiled[i]):
        assert torch.equal(a, b)


def test_trace_holds_every_span(traced):
    kinds = {_kind(s[3]) for s in traced[2]}
    assert kinds == set(PARENTS)


@pytest.mark.parametrize("kind", sorted(PARENTS))
def test_span_nests_in_its_parent_with_its_args(traced, kind):
    spans = traced[2]
    mine = [s for s in spans if _kind(s[3]) == kind]
    assert mine
    for s in mine:
        p = _parent(s, spans)
        assert (None if p is None else _kind(p[3])) in PARENTS[kind], s[3]
        got = re.findall(r" (\w+)=", s[3])
        assert got == ARGS.get(kind, []), s[3]


def test_roots_carry_distinct_ids(traced):
    spans = traced[2]
    steps = [s[3] for s in spans if _kind(s[3]) == "step"]
    assert steps == ["mlfabric.step step=0", "mlfabric.step step=1"]
    uids = [re.search(r"uid=(\d+)", s[3]).group(1) for s in spans
            if _kind(s[3]) == "commit"]
    assert len(uids) == len(set(uids)) == 4
    # each layer's forward and its recompute in the backward, every update
    n = sum(_kind(s[3]) == "fwd_bwd" for s in spans)
    for kind in ("attention", "moe"):
        names = [s[3] for s in spans if _kind(s[3]) == kind]
        assert sorted(names) == sorted(
            f"mlfabric.{kind} layer={i}" for i in range(CFG.n_layers)
            for _ in range(2 * n))


def test_moe_counters_equal_the_dispatch_one_hots(tmp_path, monkeypatch):
    """``moe/kept`` and ``moe/slots`` against the one-hots each
    ``_dispatch_chunk`` call returns, over a forward and a rematerialised
    backward; ``moe/claims`` is every token's k choices."""
    seen = {"kept": 0, "slots": 0, "claims": 0}
    orig = moe._dispatch_chunk

    def spy(x, probs, m, cap, experts=None):
        dispatch, combine = orig(x, probs, m, cap, experts)
        seen["kept"] += int(dispatch.sum())
        seen["slots"] += dispatch[:, 0].numel()
        seen["claims"] += probs.shape[0] * probs.shape[1] * m.top_k
        return dispatch, combine

    model, params = _params()
    monkeypatch.setattr(moe, "_dispatch_chunk", spy)
    _profiled(lambda: value_and_grad(
        lambda p, b: model.loss_fn(p, b, remat=True), params, _batch(3),
        has_aux=True), tmp_path)
    got = {k: int(RUNTIME.counter(f"moe/{k}").value) for k in seen}
    assert got == seen
    assert 0 < got["kept"] <= got["claims"] < got["slots"]


def test_reduce_reads_no_clock_without_a_tracer(tmp_path, monkeypatch):
    """Without a tracer ``reduce_packed`` reads no clock; under a profiler
    each bucket is one ``mlfabric.bucket`` span, in order."""
    from repro_torch.dist import collectives
    from repro_torch.dist.flatbuf import pack_leaves

    def no_clock():
        raise AssertionError("perf_counter read without a tracer")
    grads = [torch.randn(300), torch.randn(40, 20), torch.randn(7)]
    layout = collectives.plan_reduce(grads, bucket_bytes=2048)
    kw = dict(mesh=make_host_mesh(device="cpu"), intra_axis="data",
              inter_axis="pod", compress_inter=True, mean_over=1)
    with monkeypatch.context() as m:
        m.setattr(collectives.time, "perf_counter", no_clock)
        collectives.reduce_packed(pack_leaves(grads), layout, **kw)
    _, spans = _profiled(lambda: collectives.reduce_packed(
        pack_leaves(grads), layout, **kw), tmp_path)
    assert [s[3] for s in spans] == [
        f"mlfabric.bucket bucket={k} bytes={b.nbytes}"
        for k, b in enumerate(layout.buckets)]
    assert len(spans) > 1
