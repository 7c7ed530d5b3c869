"""Text processing (counterpart of ``deeplearning4j_tpu/nlp``).
Ported: the tokenizers (``tokenization.py``), which the retrieval
embedder uses. The vocabulary, Word2Vec, ParagraphVectors, GloVe,
DeepWalk and the lattice wait for ROADMAP A8."""

from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory, NGramTokenizerFactory, STOP_WORDS,
)

__all__ = ["DefaultTokenizerFactory", "NGramTokenizerFactory", "STOP_WORDS"]
