"""The port's phase-aware loss policy (``repro_torch.dist.policy``) against
the JAX package's, on the same loss curves: every query equal (the code is
pure Python on floats, copied, so equality is exact), and the same
validation errors."""

import numpy as np
import pytest

from repro.dist.policy import PhaseLossCallback as JCallback
from repro.dist.policy import PhaseLossPolicy as JPolicy
from repro_torch.dist import PhaseLossCallback, PhaseLossPolicy

CURVES = {
    "empty": [],
    "one": [3.0],
    "flat": [10.0] * 6,
    "steep": [10.0, 8.0, 6.0, 4.0],
    "decay_then_flat": [10.0 * 0.9 ** i for i in range(6)] + [5.9] * 10,
    "noisy": list(np.random.default_rng(0).normal(5.0, 0.5, 30)),
    "rising": [1.0, 2.0, 3.0],
}
KWARGS = [dict(), dict(max_loss=0.4, min_loss=0.1, ref_improvement=0.1),
          dict(max_keep=0.9, min_keep=0.2, window=3, max_bound=2.0,
               min_bound=0.5)]


def _queries(pol):
    return (pol.phase(), pol.allowed_loss(), pol.topk_keep(),
            pol.residual_bound(1.0), pol.residual_bound(3.7))


@pytest.mark.parametrize("curve", list(CURVES))
@pytest.mark.parametrize("kw", range(len(KWARGS)))
def test_policy_matches_jax_along_the_curve(curve, kw):
    jp, tp = JPolicy(**KWARGS[kw]), PhaseLossPolicy(**KWARGS[kw])
    assert _queries(tp) == _queries(jp)
    for v in CURVES[curve]:
        jp.observe(v)
        tp.observe(v)
        assert _queries(tp) == _queries(jp)


@pytest.mark.parametrize("kw", [dict(max_loss=1.0), dict(min_loss=0.5,
                                                        max_loss=0.4),
                                dict(min_keep=0.0), dict(max_keep=1.5),
                                dict(window=1), dict(ref_improvement=0.0)])
def test_validation_matches_jax(kw):
    with pytest.raises(ValueError) as jerr:
        JPolicy(**kw)
    with pytest.raises(ValueError) as terr:
        PhaseLossPolicy(**kw)
    assert str(terr.value) == str(jerr.value)


def test_callback_matches_jax():
    jp, tp = JPolicy(), PhaseLossPolicy()
    jcb, tcb = JCallback(jp, metric="loss"), PhaseLossCallback(tp,
                                                               metric="loss")
    events = [(0, {"loss": 5.0, "other": 1.0}), (1, None), (2, {"x": 2.0}),
              (3, {"loss": 4.0}), (4, {"loss": 4.0}), (5, {})]
    for step, metrics in events:
        jcb.on_batch_end(None, step, metrics)
        tcb.on_batch_end(None, step, metrics)
        assert _queries(tp) == _queries(jp)
    assert tp._history == jp._history == [5.0, 4.0, 4.0]
