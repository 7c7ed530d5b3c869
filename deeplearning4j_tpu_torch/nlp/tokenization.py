"""Tokenization: TokenizerFactory SPI + preprocessors + stopwords.

(Counterpart of ``deeplearning4j_tpu/nlp/tokenization.py``, copied with the
imports renamed: host code, no device tensor.)

Mirrors deeplearning4j-nlp's text layer (TokenizerFactory SPI,
DefaultTokenizerFactory, NGramTokenizerFactory,
CommonPreprocessor/EndingPreProcessor, stopwords list).

Language packs: the reference bundles full segmenter source trees
(ansj under deeplearning4j-nlp-chinese/src/main/java/org/ansj/,
Kuromoji under -japanese). Porting those dictionaries is out of scope,
but the SPI is proven by a REAL non-whitespace tokenizer:
:class:`CJKTokenizerFactory` segments CJK runs by forward maximum
matching against a user dictionary (the algorithmic core of ansj-style
segmenters) with per-character fallback, and handles mixed CJK/Latin
text. Any external segmenter plugs in the same way (create(text) ->
Tokenizer).
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, List, Optional

__all__ = ["Tokenizer", "DefaultTokenizerFactory",
           "NGramTokenizerFactory", "CJKTokenizerFactory",
           "CommonPreprocessor", "EndingPreProcessor", "STOP_WORDS",
           "SentenceIterator", "ListSentenceIterator",
           "FileSentenceIterator"]

# the reference's stopwords resource (stopwords file in
# deeplearning4j-nlp resources), trimmed to the common core
STOP_WORDS = frozenset("""a an and are as at be but by for if in into is it
no not of on or such that the their then there these they this to was will
with""".split())


class EndingPreProcessor:
    """Strips common English suffixes (text/tokenization/
    tokenizerfactory EndingPreProcessor: s/ed/ing/ly/.)."""

    _SUFFIXES = ("ing", "ed", "ly", "s", ".")

    def pre_process(self, token: str) -> str:
        for suf in self._SUFFIXES:
            if token.endswith(suf) and len(token) > len(suf) + 1:
                return token[:-len(suf)]
        return token


class CommonPreprocessor:
    """Lowercase + strip punctuation (CommonPreprocessor.java)."""

    _punct = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._punct.sub("", token.lower())


class Tokenizer:
    def __init__(self, tokens: List[str], preprocessor=None):
        self._tokens = tokens
        self._pre = preprocessor

    def get_tokens(self) -> List[str]:
        if self._pre is None:
            return list(self._tokens)
        out = []
        for t in self._tokens:
            t = self._pre.pre_process(t)
            if t:
                out.append(t)
        return out


class DefaultTokenizerFactory:
    """Whitespace/word tokenizer (DefaultTokenizerFactory.java)."""

    _word = re.compile(r"\S+")

    def __init__(self):
        self._pre = None

    def set_token_pre_processor(self, pre):
        self._pre = pre
        return self

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(self._word.findall(text), self._pre)


class NGramTokenizerFactory:
    """Word n-grams (NGramTokenizerFactory.java)."""

    def __init__(self, n_min: int, n_max: int):
        self.n_min = n_min
        self.n_max = n_max
        self._base = DefaultTokenizerFactory()

    def set_token_pre_processor(self, pre):
        self._base.set_token_pre_processor(pre)
        return self

    def create(self, text: str) -> Tokenizer:
        words = self._base.create(text).get_tokens()
        grams = []
        for n in range(self.n_min, self.n_max + 1):
            for i in range(len(words) - n + 1):
                grams.append(" ".join(words[i:i + n]))
        return Tokenizer(grams)


_CJK_RANGES = (
    (0x4E00, 0x9FFF),     # CJK Unified Ideographs
    (0x3400, 0x4DBF),     # CJK Extension A
    (0x3040, 0x30FF),     # Hiragana + Katakana
    (0xAC00, 0xD7AF),     # Hangul syllables
    (0xF900, 0xFAFF),     # CJK Compatibility Ideographs
)


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


class CJKTokenizerFactory:
    """Dictionary-driven CJK segmentation — the plug-in proving the
    TokenizerFactory SPI carries real language packs (reference
    deeplearning4j-nlp-chinese bundles ansj; -japanese bundles
    Kuromoji). Forward maximum matching over CJK runs (the greedy
    longest-match core ansj-style segmenters build on), one-character
    fallback for out-of-dictionary text, whitespace/regex tokenization
    for embedded Latin runs.

    ``dictionary``: iterable of multi-character CJK words. Without one,
    CJK text tokenizes per character (the standard no-resource
    baseline).
    """

    def __init__(self, dictionary: Optional[Iterable[str]] = None):
        self._dict = set(dictionary or ())
        self._max_len = max((len(w) for w in self._dict), default=1)
        self._latin = DefaultTokenizerFactory()
        self._pre = None

    def set_token_pre_processor(self, pre):
        self._pre = pre
        return self

    def add_words(self, *words: str):
        self._dict.update(words)
        self._max_len = max((len(w) for w in self._dict), default=1)
        return self

    def _segment_cjk(self, run: str) -> List[str]:
        out: List[str] = []
        i = 0
        n = len(run)
        while i < n:
            matched = None
            for l in range(min(self._max_len, n - i), 1, -1):
                if run[i:i + l] in self._dict:
                    matched = run[i:i + l]
                    break
            if matched is None:
                matched = run[i]          # single-character fallback
            out.append(matched)
            i += len(matched)
        return out

    def create(self, text: str) -> Tokenizer:
        tokens: List[str] = []
        run = []
        for ch in text:
            if _is_cjk(ch):
                run.append(ch)
            else:
                if run:
                    tokens.extend(self._segment_cjk("".join(run)))
                    run = []
                tokens.append(ch)
        if run:
            tokens.extend(self._segment_cjk("".join(run)))
        # re-tokenize the non-CJK fragments with the Latin tokenizer
        final: List[str] = []
        latin_buf = []
        for t in tokens:
            if len(t) == 1 and not _is_cjk(t):
                latin_buf.append(t)
            else:
                if latin_buf:
                    final.extend(self._latin.create(
                        "".join(latin_buf)).get_tokens())
                    latin_buf = []
                final.append(t)
        if latin_buf:
            final.extend(self._latin.create(
                "".join(latin_buf)).get_tokens())
        return Tokenizer(final, self._pre)


class SentenceIterator:
    """(sentenceiterator SPI)."""

    def __iter__(self):
        raise NotImplementedError

    def reset(self):
        pass


class ListSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Iterable[str]):
        self.sentences = list(sentences)

    def __iter__(self):
        return iter(self.sentences)


class FileSentenceIterator(SentenceIterator):
    """One sentence per line (LineSentenceIterator.java)."""

    def __init__(self, path: str):
        self.path = path

    def __iter__(self):
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if line:
                    yield line
