"""Deterministic synthetic data: an LM token stream with learnable structure
and an LDA corpus generator (for the paper's topic-modelling experiments).

The LM stream is a order-2 Markov-ish process over the vocab so that a real
model can actually *reduce loss* on it (needed by convergence tests and the
async-vs-sync example); it is deterministic in (seed, cursor) so a restarted
job resumes mid-stream exactly (checkpointable cursor).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    seed: int = 0
    structure: float = 0.8   # probability the next token is a function of prev

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # a fixed random successor table gives the stream learnable structure
        self._succ = rng.integers(0, self.vocab_size,
                                  size=(self.vocab_size,), dtype=np.int64)

    def batch(self, cursor: int, batch_size: int) -> Dict[str, np.ndarray]:
        """Batch ``cursor`` (deterministic; cursor goes into checkpoints)."""
        rng = np.random.default_rng((self.seed, cursor))
        toks = np.empty((batch_size, self.seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab_size, size=batch_size)
        noise = rng.random((batch_size, self.seq_len))
        rand_next = rng.integers(0, self.vocab_size,
                                 size=(batch_size, self.seq_len))
        for t in range(self.seq_len):
            follow = self._succ[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < self.structure,
                                      follow, rand_next[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def lda_corpus(n_docs: int, vocab_size: int, n_topics: int, doc_len: int,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate an LDA corpus (docs as bag-of-words) with known topics.

    Returns (doc_word counts [D, V], true theta [D, K], true phi [K, V]).
    """
    rng = np.random.default_rng(seed)
    phi = rng.dirichlet(np.full(vocab_size, 0.05), size=n_topics)   # [K,V]
    theta = rng.dirichlet(np.full(n_topics, 0.1), size=n_docs)      # [D,K]
    docs = np.zeros((n_docs, vocab_size), dtype=np.int32)
    for d in range(n_docs):
        z = rng.choice(n_topics, size=doc_len, p=theta[d])
        for k in np.unique(z):
            n_k = int((z == k).sum())
            words = rng.choice(vocab_size, size=n_k, p=phi[k])
            np.add.at(docs[d], words, 1)
    return docs, theta, phi
