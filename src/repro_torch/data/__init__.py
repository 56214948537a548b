from .synthetic import SyntheticLM, lda_corpus
from .pipeline import DataPipeline, ShardedBatchIterator

__all__ = ["SyntheticLM", "lda_corpus", "DataPipeline",
           "ShardedBatchIterator"]
