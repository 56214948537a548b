"""Attention heads that do not divide the ``model`` axis, split over it as
GSPMD splits them: the q heads padded up to a multiple of the axis with
zero heads, ``ceil(H / m)`` a rank, the kv heads replicated, each rank
taking those its heads read (``models/attention.py:_attend_padded``).

* The reduced qwen2-0.5b cut to 6 q and 2 KV heads of 16 on ``(data=1,
  model=4)``: 2 q heads a rank, the second rank's heads in two groups,
  the last rank's both zero heads.  The auto and the MLfabric step, the
  prefill of 4 rows and 3 decode steps (and 3 on an int8 cache) against
  the JAX package's ``build_step`` on the same mesh
  (``tests/_torch_sharded_twin.py``; its f32 rule: loss rtol 1e-5, params
  rtol 1e-4 / atol 1e-6, logits and cache 1e-5).
* ``blockwise_attention`` on DTensors in a world of four gloo processes,
  for head counts that divide the axis, that pad it, and that leave ranks
  with no real head: each rank's local q-head count is ``ceil(H / m)``,
  and the output and q's, k's and v's gradients match the unsharded
  attention within 1e-6 of their largest values.
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
# (mesh shape, q heads, kv heads): divide; q divide, kv not; neither, with
# mixed groups on a rank; fewer q heads than ranks (ranks of zero heads)
HEADS = [((2, 2), 4, 2), ((1, 4), 4, 2), ((1, 4), 6, 2), ((1, 4), 3, 1),
         ((2, 2), 3, 3)]
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


_WORLD = r"""
import json
import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import init_rank, make_mesh
from repro_torch.models import attention as attn

rank, world, extra = init_rank("gloo")
cases = json.loads(extra[0])
out = []
for (shape, h, kvh) in cases:
    mesh = make_mesh(tuple(shape), ("data", "model"), device="cpu")
    dm = mesh.device_mesh
    rng = np.random.default_rng(h * 10 + kvh)
    b, s, d = 4, 24, 8
    arrs = [rng.standard_normal((b, s, n, d)).astype(np.float32)
            for n in (h, kvh, kvh)]
    do = rng.standard_normal((b, s, h, d)).astype(np.float32)
    # the layout the projections give: batch over data, heads whole
    pl = [Shard(0) if n == "data" else Replicate()
          for n in dm.mesh_dim_names]
    seen = []

    def fn(q, k, v, **kw):
        seen.append(q.shape[2])
        return attn.blockwise_attention(q, k, v, causal=True, kv_block=8)

    attn_fn = attn.blockwise_attention
    xs = [DTensor.from_local(torch.from_numpy(a).chunk(
        mesh.shape["data"])[mesh.coords["data"]].clone(), dm, pl,
        run_check=False).requires_grad_() for a in arrs]
    got = attn._attend_local(fn, *xs)
    dod = DTensor.from_local(torch.from_numpy(do).chunk(
        mesh.shape["data"])[mesh.coords["data"]].clone(), dm, pl,
        run_check=False)
    (got * dod).sum().backward()
    ref_in = [torch.from_numpy(a).requires_grad_() for a in arrs]
    ref = attn_fn(*ref_in, causal=True, kv_block=8)
    (ref * torch.from_numpy(do)).sum().backward()
    def rel(a, b):          # relative to the largest value
        return float((a - b).abs().max() / b.abs().max())

    out.append({"seen": seen, "out": rel(got.full_tensor(), ref),
                "grads": [rel(x.grad.full_tensor(), r.grad)
                          for x, r in zip(xs, ref_in)]})
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def world():
    outs = run_local_world(_WORLD, 4, args=[json.dumps(HEADS)])
    return [json.loads(o.split("RESULT ", 1)[1].splitlines()[0])
            for o in outs]


@pytest.mark.parametrize("case", range(len(HEADS)))
def test_local_q_heads_are_ceil_h_over_m(world, case):
    (shape, h, _), m = HEADS[case], HEADS[case][0][1]
    for rank in world:
        assert rank[case]["seen"] == [math.ceil(h / m)]


@pytest.mark.parametrize("case", range(len(HEADS)))
def test_padded_split_matches_unsharded_attention(world, case):
    for rank in world:
        assert rank[case]["out"] <= RTOL
        assert max(rank[case]["grads"]) <= RTOL, rank[case]["grads"]
