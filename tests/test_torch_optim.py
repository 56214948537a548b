"""The port's schedules and AdamW against the JAX package's.

* Schedules: the f32 learning rate at every step 0..N is the reference's
  bit for bit (the CLI hands it to the optimizer and, through
  ``float(lr)``, to the replica's norm).
* AdamW: three steps from the same f32 params and gradients, eagerly in
  both packages: params, moments and the int32 step within rtol 1e-6 /
  atol 1e-7 (the same f32 formula; the bias corrections are f32 powers in
  both, and numpy-level libraries may round ``sqrt`` and the divisions of
  a fused expression differently in the last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               constant_lr, cosine_schedule,
                               step_decay_schedule, wsd_schedule)

SCHEDULES = [
    ("cosine_schedule", (0.3, 10, 100), 110),
    ("cosine_schedule", (0.3, 0, 4), 8),
    ("cosine_schedule", (1e-3, 20, 200), 210),
    ("cosine_schedule", (0.3, 400, 4000), 4010),
    ("wsd_schedule", (0.3, 10, 50, 33), 130),
    ("wsd_schedule", (0.01, 0, 3, 2), 10),
    ("step_decay_schedule", (0.1, [30, 60, 90]), 130),
    ("constant_lr", (0.3,), 5),
]


@pytest.mark.parametrize("name,args,n", SCHEDULES)
def test_schedule_bit_equal_to_reference(name, args, n):
    jf = getattr(jsched, name)(*args)
    tf = {"cosine_schedule": cosine_schedule, "wsd_schedule": wsd_schedule,
          "step_decay_schedule": step_decay_schedule,
          "constant_lr": constant_lr}[name](*args)
    want = np.array([np.float32(jf(s)) for s in range(n)], np.float32)
    got = np.array([tf(s).numpy() for s in range(n)], np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_schedule_takes_tensor_steps_and_refuses_vectors():
    f = cosine_schedule(0.3, 10, 100)
    assert torch.equal(f(torch.tensor(37)), f(37))
    with pytest.raises(ValueError):
        f(torch.arange(3))


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}


def test_adamw_three_steps_match_reference():
    p = _tree(0)
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(torch.from_numpy, p)
    js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    assert isinstance(ts, AdamWState) and ts.step.dtype == torch.int32
    for k in range(3):
        g = _tree(10 + k)
        jp, js = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                     lr=jnp.asarray(1e-2, jnp.float32))
        tp, ts = adamw_update(tp, jax.tree.map(torch.from_numpy, g), ts,
                              lr=torch.tensor(1e-2, dtype=torch.float32))
    assert int(ts.step) == int(js.step) == 3
    for a, b in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for x, y in zip(jax.tree.leaves(jax.tree.map(np.asarray, a)),
                        jax.tree.leaves(b)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=1e-6, atol=1e-7)


def test_adamw_keeps_bf16_params_and_f32_moments():
    tp = {"w": torch.ones(4, dtype=torch.bfloat16)}
    p2, s2 = adamw_update(tp, {"w": torch.full((4,), 0.5)}, adamw_init(tp),
                          lr=0.1)
    assert p2["w"].dtype == torch.bfloat16
    assert s2.mu["w"].dtype == torch.float32 and int(s2.step) == 1
    assert torch.equal(tp["w"], torch.ones(4, dtype=torch.bfloat16))
