"""Host-sharded data pipeline with prefetch and a checkpointable cursor.

Each host process loads only its shard of the global batch (``host_index`` /
``host_count``); the cursor advances deterministically so restart-from-
checkpoint replays no sample twice and skips none.  A small background
prefetch thread hides host-side generation latency behind device compute.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from .synthetic import SyntheticLM


@dataclass
class DataPipeline:
    source: SyntheticLM
    global_batch: int
    host_index: int = 0
    host_count: int = 1
    cursor: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.host_count == 0
        return self.global_batch // self.host_count

    def next_batch(self) -> Dict[str, np.ndarray]:
        full = self.source.batch(self.cursor, self.global_batch)
        self.cursor += 1
        lo = self.host_index * self.host_batch
        hi = lo + self.host_batch
        return {k: v[lo:hi] for k, v in full.items()}

    # checkpointable state ------------------------------------------------ #
    def state_dict(self) -> Dict[str, int]:
        return {"cursor": self.cursor, "seed": self.source.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        assert state["seed"] == self.source.seed, "data stream mismatch"
        self.cursor = int(state["cursor"])


class ShardedBatchIterator:
    """Prefetching iterator over a DataPipeline."""

    def __init__(self, pipeline: DataPipeline, prefetch: int = 2):
        self.pipeline = pipeline
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            batch = self.pipeline.next_batch()
            # Blocking backpressure: keep retrying the bounded queue until
            # the consumer drains a slot or shutdown is requested.  The
            # short timeout only exists to re-check the stop flag — it must
            # never discard the batch.
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    batch = None
                    break
                except queue.Full:
                    continue
            if batch is not None:
                # Shutdown interrupted an undelivered batch: rewind the
                # cursor so checkpointed progress matches what was actually
                # handed to the consumer (otherwise restart-from-checkpoint
                # silently skips this batch).
                self.pipeline.cursor -= 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set() and not self._thread.is_alive():
                    raise StopIteration

    def close(self) -> None:
        """Stop the producer and reconcile the cursor.

        Order matters: set the stop flag, *join* the worker (so no further
        put can race the drain), then rewind the cursor once per batch
        still sitting undelivered in the queue.  After close(),
        ``pipeline.state_dict()`` reflects exactly the batches the consumer
        received, so a resumed run replays no sample twice and skips none.
        """
        self._stop.set()
        self._thread.join(timeout=5.0)
        while True:
            try:
                self._q.get_nowait()
                self.pipeline.cursor -= 1
            except queue.Empty:
                break
