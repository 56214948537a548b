from .synthetic import SyntheticLM, lda_corpus

__all__ = ["SyntheticLM", "lda_corpus"]
