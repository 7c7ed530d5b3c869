"""Word2Vec over a text file (or a built-in demo corpus).

Sentence iterator -> tokenizer -> builder -> fit -> nearest-word
queries -> save vectors. The training steps run on ``--device``.

Run: python -m deeplearning4j_tpu_torch.examples.word2vec_text
     [--input corpus.txt] [--device cuda|cpu]
"""

import argparse
import os
import tempfile

DEMO = [
    "the king rules the kingdom with the queen",
    "the queen advises the king on royal matters",
    "the cat chases the mouse through the house",
    "the mouse hides from the cat in the house",
    "the king and queen host a royal feast",
    "a cat and a mouse live in the old house",
] * 50


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--input", default=None)
    p.add_argument("--out", default=None,
                   help="vector file (default: a temporary file)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from deeplearning4j_tpu_torch.nlp import Word2Vec
    from deeplearning4j_tpu_torch.nlp.serializer import write_word_vectors
    from deeplearning4j_tpu_torch.nlp.tokenization import (
        CommonPreprocessor, DefaultTokenizerFactory, FileSentenceIterator,
        ListSentenceIterator)

    it = (FileSentenceIterator(args.input) if args.input
          else ListSentenceIterator(DEMO))
    tf = DefaultTokenizerFactory()
    tf.set_token_pre_processor(CommonPreprocessor())
    w2v = (Word2Vec.builder()
           .layer_size(64)
           .window_size(5)
           .min_word_frequency(3)
           .negative_sample(5)
           .epochs(5)
           .sampling(0.0)
           .seed(42)
           .iterate(it)
           .tokenizer_factory(tf)
           .device(args.device)
           .build())
    w2v.fit()
    print(f"vocab: {len(w2v.vocab)} words")
    for word in ("king", "cat"):
        if w2v.get_word_vector(word) is not None:
            print(f"nearest({word}):", w2v.words_nearest(word, 4))
    with tempfile.TemporaryDirectory() as tmp:
        out = args.out or os.path.join(tmp, "vectors.txt")
        write_word_vectors(w2v, out)
        print(f"vectors written to {out}")
    return w2v


if __name__ == "__main__":
    main()
