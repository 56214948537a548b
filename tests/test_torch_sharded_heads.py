"""Attention heads that do not divide the ``model`` axis, split over it as
GSPMD splits them: in the blockwise loop each rank takes ``H / g`` q heads
(``g = gcd(H, m)``) and one of ``c = m / g`` chunks of the query positions
(``models/attention.py:_attend_split``); under the flash kernel, which
needs the whole sequence, the q heads are padded up to a multiple of the
axis with zero heads, ``ceil(H / m)`` a rank (``_attend_padded``).  The kv
heads are replicated, each rank taking those its heads read.

* The reduced qwen2-0.5b cut to 6 q and 2 KV heads of 16 on ``(data=1,
  model=4)``: 3 q heads (one KV group) and half the queries a rank.  The
  auto and the MLfabric step, the prefill of 4 rows and 3 decode steps
  (and 3 on an int8 cache) against the JAX package's ``build_step`` on the
  same mesh (``tests/_torch_sharded_twin.py``; its f32 rule: loss rtol
  1e-5, params rtol 1e-4 / atol 1e-6, logits and cache 1e-5).
* ``blockwise_attention`` on DTensors in a world of four gloo processes,
  for head counts that divide the axis, that do not (with mixed groups on
  a rank, and fewer q heads than ranks), a query length ``c`` does not
  divide, a causal call at a nonzero ``q_offset``, a cross-attention call
  (``Skv != Sq``) and the ``"pallas"`` route: each rank's local queries
  and q heads are ``(ceil(Sq / c), H / g)`` in the blockwise loop and
  ``(Sq, ceil(H / m))`` under the kernel, and the output and q's, k's and
  v's gradients match the unsharded attention within 1e-6 of their
  largest values (the output alone under the kernel, which has no
  backward).
"""

import json
import math

import pytest

import _torch_sharded_twin as twin
from repro_torch.launch import run_local_world

CUT = {"n_heads": 6, "n_kv_heads": 2, "d_head": 16}
TRAIN = [("qwen2-0.5b", "1x4", c) for c in ("auto", "mlfabric")]
SERVE = [("qwen2-0.5b", "1x4", k) for k in ("prefill", "decode",
                                             "decode_q8")]
# (mesh shape, q heads, kv heads, options): divide; q divide, kv not;
# neither, with mixed groups on a rank; fewer q heads than ranks; 2/2 over
# 4 (g = 2, c = 2); qwen2's 14/2 over 4 (7 heads, one KV group, a rank); a
# query length c does not divide; a causal call at a nonzero q_offset; a
# cross-attention call; the flash kernel's route, which pads the heads
HEADS = [((2, 2), 4, 2, {}), ((1, 4), 4, 2, {}), ((1, 4), 6, 2, {}),
         ((1, 4), 3, 1, {}), ((2, 2), 3, 3, {}), ((1, 4), 2, 2, {}),
         ((1, 4), 14, 2, {}), ((1, 4), 6, 2, {"sq": 25, "skv": 25}),
         ((1, 4), 3, 1, {"sq": 16, "skv": 24, "q_offset": 8}),
         ((1, 4), 6, 2, {"sq": 24, "skv": 20, "causal": False}),
         ((1, 4), 6, 2, {"sq": 32, "skv": 32, "impl": "pallas"})]
RTOL = 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return twin.run_twins(tmp_path_factory.mktemp("sharded_heads"), {
        "archs": ["qwen2-0.5b"], "cuts": {"qwen2-0.5b": CUT},
        "train": TRAIN, "serve": SERVE})


def test_ranks_agree(runs):
    twin.check_ranks_agree(runs[1])


@pytest.mark.parametrize("arch,mesh,case", TRAIN)
def test_step_matches_jax(runs, arch, mesh, case):
    twin.check_step(runs, arch, mesh, case)
    twin.check_layout(runs[2], f"{arch}/{mesh}/{case}")


@pytest.mark.parametrize("arch,mesh,kind", SERVE)
def test_serve_matches_jax(runs, arch, mesh, kind):
    twin.check_serve(runs, arch, mesh, kind)
    twin.check_layout(runs[2], f"{arch}/{mesh}/{kind}")


def test_local_heads_rule():
    """Each rank's heads are its block of the padded count, and each reads
    its own group's kv head (a padded head the last real head's)."""
    from repro_torch.models.attention import local_heads
    heads, kv = local_heads(6, 2, 4, 1)
    assert list(heads) == [2, 3] and kv == [0, 1]
    heads, kv = local_heads(14, 2, 16, 15)
    assert list(heads) == [15] and kv == [1]
    for h, kvh, m in ((14, 2, 16), (14, 2, 4), (6, 6, 16), (28, 4, 16)):
        g = h // kvh
        got = [local_heads(h, kvh, m, r) for r in range(m)]
        assert all(len(hs) == math.ceil(h / m) for hs, _ in got)
        flat = [j for hs, _ in got for j in hs]
        assert flat == list(range(math.ceil(h / m) * m))
        assert all(k == min(j, h - 1) // g for hs, ks in got
                   for j, k in zip(hs, ks))


def test_query_split_rule():
    """Rank r takes head group r % g and query chunk r // g: every (head,
    chunk) once, and with q heads that divide the axis the plain split."""
    from repro_torch.models.attention import query_split
    heads, chunk, c = query_split(6, 16, 5)
    assert list(heads) == [3, 4, 5] and (chunk, c) == (2, 8)
    for h, m in ((6, 16), (14, 16), (36, 16), (28, 16), (2, 4), (8, 4)):
        g = math.gcd(h, m)
        got = [query_split(h, m, r) for r in range(m)]
        assert all(len(hs) == h // g and c == m // g for hs, _, c in got)
        assert sorted((j, ch) for hs, ch, _ in got for j in hs) == [
            (j, ch) for j in range(h) for ch in range(m // g)]
    assert [list(query_split(8, 4, r)[0]) for r in range(4)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]


_WORLD = r"""
import json
import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import init_rank, make_mesh
from repro_torch.models import attention as attn

rank, world, extra = init_rank("gloo")
cases = json.loads(extra[0])
blockwise = attn.blockwise_attention
seen = []


def spy(q, k, v, **kw):
    # the local call each rank makes: its queries, q heads and offset
    seen.append([q.shape[1], q.shape[2], kw["q_offset"]])
    return blockwise(q, k, v, **kw)


out = []
for (shape, h, kvh, opt) in cases:
    mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
    dm = mesh.device_mesh
    rng = np.random.default_rng(h * 10 + kvh)
    b, d = 4, 8
    sq, skv = opt.get("sq", 24), opt.get("skv", 24)
    kw = dict(causal=opt.get("causal", True), q_offset=opt.get("q_offset", 0),
              kv_block=8)
    grad = opt.get("impl", "blockwise") == "blockwise"
    arrs = [rng.standard_normal((b, n, hh, d)).astype(np.float32)
            for n, hh in ((sq, h), (skv, kvh), (skv, kvh))]
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    # the layout the projections give: batch over data, heads whole
    pl = [Shard(0) if n == "data" else Replicate()
          for n in dm.mesh_dim_names]

    def dt(a):
        return DTensor.from_local(torch.from_numpy(a).chunk(
            mesh.shape["data"])[mesh.coords["data"]].clone(), dm, pl,
            run_check=False)

    xs = [dt(a).requires_grad_(grad) for a in arrs]
    attn.set_attention_impl(opt.get("impl", "blockwise"))
    seen.clear()
    attn.blockwise_attention = spy
    try:
        with torch.set_grad_enabled(grad):
            got = blockwise(*xs, **kw)
    finally:
        attn.blockwise_attention = blockwise
    local = list(seen)
    ref_in = [torch.from_numpy(a).requires_grad_(grad) for a in arrs]
    with torch.set_grad_enabled(grad):
        ref = blockwise(*ref_in, **kw)
    attn.set_attention_impl("blockwise")

    def rel(a, b):          # relative to the largest value
        return float((a - b).abs().max() / b.abs().max())

    res = {"seen": local, "out": rel(got.full_tensor().detach(),
                                     ref.detach())}
    if grad:
        (got * dt(do)).sum().backward()
        (ref * torch.from_numpy(do)).sum().backward()
        res["grads"] = [rel(x.grad.full_tensor(), r.grad)
                        for x, r in zip(xs, ref_in)]
    out.append(res)
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def world():
    outs = run_local_world(_WORLD, 4, args=[json.dumps(HEADS)])
    return [json.loads(o.split("RESULT ", 1)[1].splitlines()[0])
            for o in outs]


@pytest.mark.parametrize("case", range(len(HEADS)))
def test_local_q_heads_are_ceil_h_over_m(world, case):
    """Each rank's local (queries, q heads, offset): ``(ceil(Sq / c), H /
    g)`` at ``q_offset`` plus its chunk's start in the blockwise loop
    (``query_split``); ``(Sq, ceil(H / m))`` under the flash kernel, whose
    route pads the heads."""
    from repro_torch.models.attention import query_split
    (shape, h, kvh, opt), m = HEADS[case], HEADS[case][0][1]
    sq, off = opt.get("sq", 24), opt.get("q_offset", 0)
    for r, rank in enumerate(world):
        if opt.get("impl") == "pallas":
            assert rank[case]["seen"] == [[sq, math.ceil(h / m), off]]
            continue
        _, chunk, c = query_split(h, m, r % m)
        cs = math.ceil(sq / c)
        assert rank[case]["seen"] == [[cs, h // math.gcd(h, m),
                                       off + chunk * cs]]


@pytest.mark.parametrize("case", range(len(HEADS)))
def test_padded_split_matches_unsharded_attention(world, case):
    for rank in world:
        assert rank[case]["out"] <= RTOL
        if "grads" in rank[case]:
            assert max(rank[case]["grads"]) <= RTOL, rank[case]["grads"]
