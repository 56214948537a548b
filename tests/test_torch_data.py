"""The port's data pipeline (a copy: it is numpy only) against the JAX
package's: the same batches, host shards and ``state_dict`` for one seed,
and the twins of ``tests/test_data_pipeline.py``'s four tests (no batch
dropped under backpressure, the cursor reconciled on ``close``, restart
replaying nothing and skipping nothing, iteration ending after ``close``).
Exact equality throughout: nothing here is floating-point arithmetic.
"""

import time

import numpy as np
import pytest

from repro.data.pipeline import DataPipeline as JDataPipeline
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro_torch.data import DataPipeline, ShardedBatchIterator, SyntheticLM


@pytest.mark.parametrize("host_count", [1, 2])
def test_batches_and_state_match_reference(host_count):
    for host in range(host_count):
        j = JDataPipeline(JSyntheticLM(vocab_size=53, seq_len=12, seed=3),
                          global_batch=4, host_index=host,
                          host_count=host_count)
        t = DataPipeline(SyntheticLM(vocab_size=53, seq_len=12, seed=3),
                         global_batch=4, host_index=host,
                         host_count=host_count)
        for _ in range(5):
            jb, tb = j.next_batch(), t.next_batch()
            assert jb.keys() == tb.keys()
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(jb[k], tb[k])
        assert t.state_dict() == j.state_dict() == {"cursor": 5, "seed": 3}
        t2 = DataPipeline(SyntheticLM(vocab_size=53, seq_len=12, seed=3),
                          global_batch=4)
        t2.load_state_dict(j.state_dict())
        assert t2.cursor == 5
        with pytest.raises(AssertionError):
            DataPipeline(SyntheticLM(vocab_size=53, seq_len=12, seed=4),
                         global_batch=4).load_state_dict(j.state_dict())


def _pipeline(**kw):
    src = SyntheticLM(vocab_size=37, seq_len=8, seed=5)
    return DataPipeline(src, global_batch=4, **kw)


def _batch_ids(batches):
    """Recover each batch's cursor id by regenerating from the source."""
    src = SyntheticLM(vocab_size=37, seq_len=8, seed=5)
    ids = []
    for b in batches:
        for cur in range(200):
            ref = src.batch(cur, 4)
            if all(np.array_equal(ref[k], b[k]) for k in b):
                ids.append(cur)
                break
        else:
            raise AssertionError("batch not produced by any cursor")
    return ids


def test_port_no_batch_dropped_under_slow_consumer():
    """A consumer slower than the producer (tiny queue, constant
    backpressure) must still see every batch exactly once, in order."""
    it = ShardedBatchIterator(_pipeline(), prefetch=1)
    try:
        got = []
        for _ in range(12):
            time.sleep(0.01)          # slower than generation: queue full
            got.append(next(it))
    finally:
        it.close()
    assert _batch_ids(got) == list(range(12)), (
        "prefetch queue dropped or reordered a batch under backpressure")


def test_port_close_reconciles_cursor_with_delivery():
    """After close(), the cursor counts only delivered batches: prefetched
    but unconsumed batches (queued or mid-handoff) are rewound, so a
    checkpoint taken after shutdown resumes without skipping data."""
    pipe = _pipeline()
    it = ShardedBatchIterator(pipe, prefetch=3)
    consumed = [next(it) for _ in range(2)]
    time.sleep(0.2)                   # let the producer fill the queue
    it.close()
    assert pipe.cursor == len(consumed), (pipe.cursor, len(consumed))
    assert _batch_ids(consumed) == [0, 1]


def test_port_restart_from_checkpoint_replays_nothing_and_skips_nothing():
    pipe = _pipeline()
    it = ShardedBatchIterator(pipe, prefetch=2)
    first = [next(it) for _ in range(3)]
    it.close()
    state = pipe.state_dict()

    resumed = _pipeline()
    resumed.load_state_dict(state)
    it2 = ShardedBatchIterator(resumed, prefetch=2)
    second = [next(it2) for _ in range(3)]
    it2.close()
    assert _batch_ids(first + second) == list(range(6))


def test_port_iteration_stops_after_close():
    it = ShardedBatchIterator(_pipeline(), prefetch=1)
    next(it)
    it.close()
    # drain whatever close() could not rewind (nothing, since it joins
    # first), then the iterator must terminate instead of blocking forever
    try:
        while True:
            next(it)
    except StopIteration:
        pass
