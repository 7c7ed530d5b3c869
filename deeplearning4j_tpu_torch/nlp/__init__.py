"""Text processing (counterpart of ``deeplearning4j_tpu/nlp``): the
tokenizers, the vocabulary and Huffman coding, Word2Vec / SequenceVectors
(skip-gram and CBOW, negative sampling and hierarchical softmax),
ParagraphVectors, GloVe, DeepWalk / Node2Vec (``deepwalk``), the
word-vector format and vectorizers (``serializer``), the CJK lattice
segmenter (``lattice``) and the annotators (``annotation``). The
trainers' steps are torch on the model's ``device``; the rest is host
code."""

from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory, NGramTokenizerFactory, STOP_WORDS,
)
from deeplearning4j_tpu_torch.nlp.vocab import (VocabCache, VocabConstructor,
                                                Huffman)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec, SequenceVectors
from deeplearning4j_tpu_torch.nlp.paragraph_vectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.glove import Glove

__all__ = ["DefaultTokenizerFactory", "NGramTokenizerFactory", "STOP_WORDS",
           "VocabCache", "VocabConstructor", "Huffman", "Word2Vec",
           "SequenceVectors", "ParagraphVectors", "Glove"]
