"""Composable text-annotation pipeline — the UIMA-module analog.

(Counterpart of ``deeplearning4j_tpu/nlp/annotation.py``, copied with the
imports renamed: host code, no device tensor.)

The reference ships ``deeplearning4j-nlp-uima``: annotators
(SentenceAnnotator.java, TokenizerAnnotator.java, StemmerAnnotator.java)
composed as UIMA analysis-engine pipelines over a shared CAS document,
plus tokenizer factories that expose a pipeline through the
tokenization SPI (UimaTokenizerFactory.java:40-76). What is
architecturally load-bearing is the COMPOSITION model: each annotator
reads the document plus previously-added span annotations and adds its
own layer. This module is that model without the UIMA machinery:

- :class:`AnnotatedDocument` — text + typed span annotations (the CAS
  analog, a plain data object);
- :class:`Annotator` — the analysis-engine SPI (``process(doc)``);
- :class:`SentenceAnnotator` — rule-based sentence spans (the
  reference wraps an OpenNLP statistical model; the rule-based
  splitter keeps the pack self-contained — no model files);
- :class:`TokenizerAnnotator` — token spans inside sentence spans,
  driven by ANY TokenizerFactory (including the lattice CJK packs);
- :class:`StemmerAnnotator` — Porter stems as token features
  (StemmerAnnotator.java wraps Snowball; Porter is its English core);
- :class:`AnnotatorPipeline` — ordered composition;
- :class:`AnnotationTokenizerFactory` — exposes a pipeline through
  the tokenization SPI, the UimaTokenizerFactory analog.

De-scoped knowingly (see COMPONENTS.md): the treeparser corner
(corpora/treeparser — constituency trees need a parser model the
reference gets from ClearTK/OpenNLP), SentiWordNet scoring (SWN3.java
wraps a 13MB lexicon), and model-file-based POS tagging. Each wraps
an external model artifact rather than framework machinery.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional

__all__ = ["Annotation", "AnnotatedDocument", "Annotator",
           "SentenceAnnotator", "TokenizerAnnotator",
           "StemmerAnnotator", "AnnotatorPipeline",
           "AnnotationTokenizerFactory", "porter_stem"]


@dataclasses.dataclass
class Annotation:
    """A typed span over the document text (the UIMA Annotation
    analog). ``features`` carries annotator-added attributes (e.g.
    the stem of a token)."""
    type: str
    begin: int
    end: int
    features: Dict[str, str] = dataclasses.field(default_factory=dict)

    def covered_text(self, text: str) -> str:
        return text[self.begin:self.end]


class AnnotatedDocument:
    """Text + annotation layers (the CAS analog)."""

    def __init__(self, text: str):
        self.text = text
        self.annotations: List[Annotation] = []

    def add(self, ann: Annotation) -> None:
        self.annotations.append(ann)

    def select(self, type_: str) -> List[Annotation]:
        """Annotations of a type, in document order."""
        return sorted((a for a in self.annotations if a.type == type_),
                      key=lambda a: (a.begin, a.end))

    def covered(self, ann: Annotation, type_: str) -> List[Annotation]:
        """Annotations of ``type_`` inside ``ann``'s span (UIMA's
        selectCovered)."""
        return [a for a in self.select(type_)
                if a.begin >= ann.begin and a.end <= ann.end]


class Annotator:
    """Analysis-engine SPI: mutate ``doc`` by adding annotations."""

    def process(self, doc: AnnotatedDocument) -> None:
        raise NotImplementedError


_ABBREV = frozenset({
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc",
    "e.g", "i.e", "fig", "al", "inc", "ltd", "co", "corp", "no",
    "vol", "pp", "approx", "dept", "est", "min", "max"})

_SENT_BOUNDARY = re.compile(r"[.!?。！？]+[\"'”’)\]]*\s+|[.!?。！？]+[\"'”’)\]]*$")


class SentenceAnnotator(Annotator):
    """Sentence spans via punctuation rules with an abbreviation
    guard (the SentenceAnnotator.java slot; rule-based so no model
    file ships). Handles ASCII and CJK terminators."""

    def process(self, doc: AnnotatedDocument) -> None:
        text = doc.text
        start = 0
        for m in _SENT_BOUNDARY.finditer(text):
            # abbreviation guard: 'Dr. Smith' must not split
            head = text[start:m.start() + 1]
            last = re.split(r"\s+", head.strip())[-1] if head.strip() \
                else ""
            word = last.rstrip(".").lower()
            if last.endswith(".") and (word in _ABBREV
                                       or (len(word) == 1
                                           and word.isalpha())):
                continue
            end = m.end()
            seg = text[start:end].strip()
            if seg:
                b = start + (len(text[start:end])
                             - len(text[start:end].lstrip()))
                doc.add(Annotation("sentence", b, b + len(seg)))
            start = end
        tail = text[start:].strip()
        if tail:
            b = start + (len(text[start:]) - len(text[start:].lstrip()))
            doc.add(Annotation("sentence", b, b + len(tail)))


class TokenizerAnnotator(Annotator):
    """Token spans inside each sentence span, via any
    TokenizerFactory (TokenizerAnnotator.java slot — and because the
    factory is pluggable, the lattice zh/ja/ko packs ride the same
    pipeline). Runs document-wide if no sentence annotations exist."""

    def __init__(self, tokenizer_factory=None):
        if tokenizer_factory is None:
            from deeplearning4j_tpu_torch.nlp.tokenization import (
                DefaultTokenizerFactory)
            tokenizer_factory = DefaultTokenizerFactory()
        self.factory = tokenizer_factory

    _PUNCT = ".,;:!?\"'`()[]{}«»„“”‘’—–…。、，！？；：（）「」『』"

    def process(self, doc: AnnotatedDocument) -> None:
        spans = doc.select("sentence") or [
            Annotation("sentence", 0, len(doc.text))]
        for s in spans:
            seg = s.covered_text(doc.text)
            pos = 0
            for tok in self.factory.create(seg).get_tokens():
                found = seg.find(tok, pos)
                if found < 0:        # preprocessor rewrote the token:
                    #                  anchor best-effort at `pos`
                    found = pos
                pos = found + len(tok)
                # surrounding punctuation stays out of the token span
                # (the UIMA/ClearTK tokenizers emit punctuation
                # separately; the whitespace default does not)
                core = tok.strip(self._PUNCT)
                if not core:
                    continue
                off = tok.find(core)
                doc.add(Annotation(
                    "token", s.begin + found + off,
                    s.begin + found + off + len(core)))


class StemmerAnnotator(Annotator):
    """Adds a ``stem`` feature to every token annotation
    (StemmerAnnotator.java slot; Porter instead of Snowball-English —
    same algorithm family, self-contained)."""

    def process(self, doc: AnnotatedDocument) -> None:
        for tok in doc.select("token"):
            tok.features["stem"] = porter_stem(
                tok.covered_text(doc.text))


class AnnotatorPipeline(Annotator):
    """Ordered composition (the analysis-engine aggregate):
    ``AnnotatorPipeline([SentenceAnnotator(), TokenizerAnnotator(),
    StemmerAnnotator()]).annotate(text)``."""

    def __init__(self, annotators: Iterable[Annotator]):
        self.annotators = list(annotators)

    def process(self, doc: AnnotatedDocument) -> None:
        for a in self.annotators:
            a.process(doc)

    def annotate(self, text: str) -> AnnotatedDocument:
        doc = AnnotatedDocument(text)
        self.process(doc)
        return doc


class AnnotationTokenizerFactory:
    """TokenizerFactory SPI over an annotator pipeline
    (UimaTokenizerFactory.java:40-76 analog): tokenize() runs
    sentence + token annotators and returns token texts — or their
    ``stem`` feature with ``use_stems=True`` (the
    PosUimaTokenizerFactory pattern of reading a feature instead of
    the surface form)."""

    def __init__(self, pipeline: Optional[AnnotatorPipeline] = None,
                 *, use_stems: bool = False):
        if pipeline is None:
            anns: List[Annotator] = [SentenceAnnotator(),
                                     TokenizerAnnotator()]
            if use_stems:
                anns.append(StemmerAnnotator())
            pipeline = AnnotatorPipeline(anns)
        self.pipeline = pipeline
        self.use_stems = use_stems
        self._pre = None

    def set_token_pre_processor(self, pre) -> None:
        self._pre = pre

    def create(self, text: str):
        from deeplearning4j_tpu_torch.nlp.tokenization import Tokenizer
        doc = self.pipeline.annotate(text)
        toks = []
        for t in doc.select("token"):
            if self.use_stems and "stem" in t.features:
                toks.append(t.features["stem"])
            else:
                toks.append(t.covered_text(doc.text))
        return Tokenizer(toks, self._pre)


# ---------------------------------------------------------------------------
# Porter stemmer — implemented from the published algorithm (Porter,
# "An algorithm for suffix stripping", 1980). Self-contained so the
# stemming annotator needs no external lexicon.
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """The [C](VC)^m[V] measure."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        if _is_cons(stem, i):
            if prev_vowel:
                m += 1
            prev_vowel = False
        else:
            prev_vowel = True
    return m


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(stem: str) -> bool:
    return (len(stem) >= 2 and stem[-1] == stem[-2]
            and _is_cons(stem, len(stem) - 1))


def _cvc(stem: str) -> bool:
    if len(stem) < 3:
        return False
    return (_is_cons(stem, len(stem) - 3)
            and not _is_cons(stem, len(stem) - 2)
            and _is_cons(stem, len(stem) - 1)
            and stem[-1] not in "wxy")


def porter_stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2 or not w.isalpha():
        return w
    # step 1a
    for suf, rep in (("sses", "ss"), ("ies", "i"), ("ss", "ss"),
                     ("s", "")):
        if w.endswith(suf):
            w = w[:-len(suf)] + rep
            break
    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    else:
        hit = None
        for suf in ("ed", "ing"):
            if w.endswith(suf) and _has_vowel(w[:-len(suf)]):
                hit = suf
                break
        if hit:
            w = w[:-len(hit)]
            if w.endswith(("at", "bl", "iz")):
                w += "e"
            elif _ends_double_cons(w) and w[-1] not in "lsz":
                w = w[:-1]
            elif _measure(w) == 1 and _cvc(w):
                w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    for suf, rep in (("ational", "ate"), ("tional", "tion"),
                     ("enci", "ence"), ("anci", "ance"),
                     ("izer", "ize"), ("abli", "able"),
                     ("alli", "al"), ("entli", "ent"), ("eli", "e"),
                     ("ousli", "ous"), ("ization", "ize"),
                     ("ation", "ate"), ("ator", "ate"),
                     ("alism", "al"), ("iveness", "ive"),
                     ("fulness", "ful"), ("ousness", "ous"),
                     ("aliti", "al"), ("iviti", "ive"),
                     ("biliti", "ble")):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 3
    for suf, rep in (("icate", "ic"), ("ative", ""), ("alize", "al"),
                     ("iciti", "ic"), ("ical", "ic"), ("ful", ""),
                     ("ness", "")):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 4
    for suf in ("al", "ance", "ence", "er", "ic", "able", "ible",
                "ant", "ement", "ment", "ent", "ou", "ism", "ate",
                "iti", "ous", "ive", "ize"):
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 1:
                w = w[:-len(suf)]
            break
    else:
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" \
                and _measure(w[:-3]) > 1:
            w = w[:-3]
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w
