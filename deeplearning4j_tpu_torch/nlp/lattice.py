"""Lattice + Viterbi CJK segmentation — the Kuromoji/ansj architecture.

(Counterpart of ``deeplearning4j_tpu/nlp/lattice.py``, copied with the
imports renamed: host code, no device tensor.)

The reference bundles two full morphological analyzers: Kuromoji for
Japanese (deeplearning4j-nlp-japanese/src/main/java/com/atilika/
kuromoji/viterbi/ViterbiBuilder.java builds the lattice,
ViterbiSearcher.java walks it) and ansj for Chinese
(deeplearning4j-nlp-chinese/src/main/java/org/ansj/). Both resolve
segmentation AMBIGUITY the same way: every dictionary word that occurs
at every position becomes a lattice node; each node carries a word
cost (from corpus frequency) and adjacent nodes a connection cost; the
minimum-cost path through the lattice is the segmentation. Greedy
forward-maximum-matching (tokenization.CJKTokenizerFactory) cannot do
this — at 研究生命起源 it grabs the longest match 研究生 and is stuck
with the wrong 研究生|命|起源; the lattice compares whole-path costs
and recovers 研究|生命|起源.

This module is that architecture, TPU-framework-sized:

- :class:`LatticeDictionary` — words with costs (built from counts:
  cost = -log p, the unigram view of Kuromoji's word cost column) and
  an optional tag-pair connection matrix (the connection-cost matrix);
- :class:`ViterbiSegmenter` — lattice construction + min-cost dynamic
  program + backtrack, with Kuromoji-style unknown-word handling:
  out-of-dictionary characters group by character class (kanji run,
  katakana run, ...) with a length-scaled penalty, so unseen names
  stay whole instead of shattering into characters;
- :class:`LatticeCJKTokenizerFactory` — TokenizerFactory SPI plug-in:
  CJK runs go through the lattice, embedded Latin through the default
  tokenizer (same contract as CJKTokenizerFactory).
"""

from __future__ import annotations

import gzip
import math
import os
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from deeplearning4j_tpu_torch.nlp.tokenization import (DefaultTokenizerFactory,
                                                 Tokenizer, _is_cjk)

__all__ = ["LatticeDictionary", "ViterbiSegmenter",
           "LatticeCJKTokenizerFactory", "small_cjk_dictionary",
           "chinese_dictionary", "japanese_dictionary",
           "korean_dictionary", "compile_dictionary"]

# ---------------------------------------------------------------------------
# Dictionary file format (the Kuromoji TSV → binary pipeline analog;
# reference compiles feature TSVs via DictionaryField.java /
# kuromoji-compile into binary dictionaries):
#
#   # comment
#   word<TAB>count<TAB>tag          entries (tag optional, default *)
#   @conn<TAB>left<TAB>right<TAB>cost   tag-pair connection costs
#
# Counts become word costs via -log(count/total) at load. `.tsv` and
# `.tsv.gz` are the source format; `compile_dictionary()` bakes the
# normalized costs into a `.npz` that loads without re-parsing — the
# binary-dictionary analog. Two non-toy dictionaries ship with the
# package (`nlp/data/`): zh_core (~65k entries derived from jieba's
# MIT-licensed frequency dictionary — tools/build_zh_dictionary.py)
# and ja_core (~560 curated morphemes: the closed-class particles and
# auxiliaries that drive Japanese segmentation, plus common content
# words and a tag-pair connection matrix).
# ---------------------------------------------------------------------------


class LatticeDictionary:
    """Word → (cost, tag). Costs are -log relative frequency when
    built via :meth:`from_counts` (Kuromoji stores corpus-derived
    costs in its dictionary binary; same quantity, readable form).
    ``connections`` maps (left_tag, right_tag) → cost, defaulting 0
    (the full analyzers learn a dense matrix; the hook is the
    architecture, the default keeps small dictionaries usable)."""

    def __init__(self, entries: Mapping[str, float] | None = None,
                 tags: Optional[Mapping[str, str]] = None,
                 connections: Optional[Mapping[Tuple[str, str],
                                               float]] = None):
        self._cost: Dict[str, float] = dict(entries or {})
        self._tag: Dict[str, str] = dict(tags or {})
        self._conn: Dict[Tuple[str, str], float] = dict(connections
                                                        or {})
        self._max_len = max((len(w) for w in self._cost), default=1)

    @classmethod
    def from_counts(cls, counts: Mapping[str, float], **kw):
        total = float(sum(counts.values())) or 1.0
        return cls({w: -math.log(c / total)
                    for w, c in counts.items() if c > 0}, **kw)

    @classmethod
    def from_tsv(cls, path: str) -> "LatticeDictionary":
        """Load the TSV source format (module docstring above);
        transparently handles ``.gz``."""
        counts: Dict[str, float] = {}
        tags: Dict[str, str] = {}
        conns: Dict[Tuple[str, str], float] = {}
        op = gzip.open if str(path).endswith(".gz") else open
        with op(path, "rt", encoding="utf-8") as f:
            for ln, line in enumerate(f, 1):
                line = line.rstrip("\r\n")   # tolerate CRLF-authored
                #                              files: '\r' in the last
                #                              field would corrupt tags
                if not line or line.startswith("#"):
                    continue
                parts = line.split("\t")
                if parts[0] == "@conn":
                    if len(parts) != 4:
                        raise ValueError(
                            f"{path}:{ln}: @conn needs left, right, "
                            f"cost — got {line!r}")
                    try:
                        conns[(parts[1], parts[2])] = float(parts[3])
                    except ValueError:
                        raise ValueError(f"{path}:{ln}: bad @conn "
                                         f"cost {parts[3]!r}") from None
                    continue
                if len(parts) < 2:
                    raise ValueError(f"{path}:{ln}: expected "
                                     f"word<TAB>count — got {line!r}")
                word = parts[0]
                try:
                    count = float(parts[1])
                except ValueError:
                    raise ValueError(f"{path}:{ln}: bad count "
                                     f"{parts[1]!r} for {word!r}") \
                        from None
                counts[word] = counts.get(word, 0.0) + count
                if len(parts) > 2 and parts[2] != "*":
                    tags[word] = parts[2]
        return cls.from_counts(counts, tags=tags, connections=conns)

    @classmethod
    def load(cls, path: str) -> "LatticeDictionary":
        """Dispatch on extension: ``.npz`` compiled, else TSV."""
        if str(path).endswith(".npz"):
            import numpy as np
            z = np.load(path, allow_pickle=False)
            words = [str(w) for w in z["words"]]
            costs = z["costs"]
            tags = {str(w): str(t)
                    for w, t in zip(z["tag_words"], z["tag_values"])}
            conns = {(str(l), str(r)): float(c)
                     for l, r, c in zip(z["conn_left"], z["conn_right"],
                                        z["conn_cost"])}
            return cls(dict(zip(words, costs.tolist())), tags=tags,
                       connections=conns)
        return cls.from_tsv(path)

    def save_compiled(self, path: str) -> str:
        """Bake into the `.npz` compiled form (normalized costs, no
        re-parse at load) — the binary-dictionary analog of
        kuromoji-compile."""
        import numpy as np
        words = sorted(self._cost)
        np.savez_compressed(
            path,
            words=np.array(words),
            costs=np.array([self._cost[w] for w in words], np.float64),
            tag_words=np.array(sorted(self._tag)),
            tag_values=np.array([self._tag[w]
                                 for w in sorted(self._tag)]),
            conn_left=np.array([k[0] for k in sorted(self._conn)]),
            conn_right=np.array([k[1] for k in sorted(self._conn)]),
            conn_cost=np.array([self._conn[k]
                                for k in sorted(self._conn)],
                               np.float64))
        return path if str(path).endswith(".npz") else path + ".npz"

    @property
    def max_len(self) -> int:
        return self._max_len

    def __contains__(self, word: str) -> bool:
        return word in self._cost

    def words(self):
        return self._cost.keys()

    def cost(self, word: str) -> float:
        return self._cost[word]

    def tag(self, word: str) -> str:
        return self._tag.get(word, "*")

    def connection(self, left_tag: str, right_tag: str) -> float:
        return self._conn.get((left_tag, right_tag), 0.0)

    def add(self, word: str, cost: float, tag: str = "*"):
        self._cost[word] = cost
        if tag != "*":
            self._tag[word] = tag
        self._max_len = max(self._max_len, len(word))
        return self


# character classes whose unknown-word candidates are generated even
# where dictionary words start (Kuromoji unknown invoke=1) — scripts
# where unseen stems fuse with known attachments
_ALWAYS_INVOKE = frozenset({"hangul", "katakana"})
_UNK_MAX_LEN = 12          # bound on invoke-always candidate length


def _char_class(ch: str) -> str:
    cp = ord(ch)
    if 0x3040 <= cp <= 0x309F:
        return "hiragana"
    if 0x30A0 <= cp <= 0x30FF:
        return "katakana"
    if 0xAC00 <= cp <= 0xD7AF:
        return "hangul"
    return "kanji"


class _Node:
    __slots__ = ("start", "end", "word", "cost", "tag", "best",
                 "back")

    def __init__(self, start, end, word, cost, tag):
        self.start = start
        self.end = end
        self.word = word
        self.cost = cost
        self.tag = tag
        self.best = math.inf     # min path cost up to and incl. self
        self.back = None


class ViterbiSegmenter:
    """Min-cost path through the word lattice (ViterbiSearcher.java's
    forward pass + backtrack, over ViterbiBuilder.java's lattice).

    ``unknown_cost``: per-character penalty for out-of-dictionary
    runs. Higher than any real word cost, so dictionary words are
    preferred, but one grouped unknown beats N singletons."""

    def __init__(self, dictionary: LatticeDictionary, *,
                 unknown_cost: float = 12.0):
        self.dict = dictionary
        self.unknown_cost = unknown_cost

    def _lattice(self, text: str) -> List[List[_Node]]:
        n = len(text)
        ending: List[List[_Node]] = [[] for _ in range(n + 1)]
        starts_covered = [False] * n
        for i in range(n):
            for l in range(1, min(self.dict.max_len, n - i) + 1):
                w = text[i:i + l]
                if w in self.dict:
                    ending[i + l].append(_Node(
                        i, i + l, w, self.dict.cost(w),
                        self.dict.tag(w)))
                    starts_covered[i] = True
        # unknown-word nodes: group maximal same-class runs starting at
        # positions no dictionary word covers (Kuromoji's unknown-word
        # processing groups by character class)
        for i in range(n):
            if starts_covered[i]:
                # also add the single char as an escape hatch so a
                # mid-word dictionary gap can't disconnect the lattice
                ending[i + 1].append(_Node(i, i + 1, text[i],
                                           self.unknown_cost, "unk"))
                continue
            cls = _char_class(text[i])
            j = i + 1
            while (j < n and not starts_covered[j]
                   and _char_class(text[j]) == cls):
                j += 1
            # the run and every prefix (prefixes keep the DP connected
            # when a dictionary word begins mid-run)
            for end in range(i + 1, j + 1):
                ending[end].append(_Node(
                    i, end, text[i:end],
                    self.unknown_cost * (1.0 + 0.3 * (end - i - 1)),
                    "unk"))
        # invoke-always classes (Kuromoji's unknown-word policy
        # invoke=1 for KATAKANA; hangul added here): from every CLASS
        #-RUN start, emit the run and its prefixes even THROUGH
        # positions where dictionary words also start. Agglutinative
        # scripts need this: an unseen Korean stem like 블록체인 must
        # stay a candidate although the dictionary ending 인 starts
        # inside it — without these nodes the only path is 블록체|인.
        for i in range(n):
            cls = _char_class(text[i])
            if cls not in _ALWAYS_INVOKE:
                continue
            if i > 0 and _char_class(text[i - 1]) == cls:
                continue                  # only class-run starts
            j = i + 1
            while j < n and _char_class(text[j]) == cls:
                j += 1
            # for an uncovered start the loop above already emitted
            # prefixes up to the first covered position — only the
            # spans BEYOND that truncation point are new
            first = i + 1
            if not starts_covered[i]:
                j1 = i + 1
                while j1 < n and not starts_covered[j1] \
                        and _char_class(text[j1]) == cls:
                    j1 += 1
                first = j1 + 1
            for end in range(first, min(j, i + _UNK_MAX_LEN) + 1):
                ending[end].append(_Node(
                    i, end, text[i:end],
                    self.unknown_cost * (1.0 + 0.3 * (end - i - 1)),
                    "unk"))
        return ending

    def segment(self, text: str) -> List[str]:
        if not text:
            return []
        n = len(text)
        ending = self._lattice(text)
        # forward DP over node ends; virtual BOS has cost 0 / tag *
        best_at: List[List[_Node]] = [[] for _ in range(n + 1)]
        for end in range(1, n + 1):
            for node in ending[end]:
                if node.start == 0:
                    node.best = node.cost
                    node.back = None
                else:
                    for prev in best_at[node.start]:
                        c = (prev.best + node.cost
                             + self.dict.connection(prev.tag, node.tag))
                        if c < node.best:
                            node.best = c
                            node.back = prev
                if node.best < math.inf:
                    best_at[end].append(node)
        tail = min(best_at[n], key=lambda nd: nd.best, default=None)
        if tail is None:                 # disconnected (shouldn't happen)
            return list(text)
        out: List[str] = []
        node = tail
        while node is not None:
            out.append(node.word)
            node = node.back
        return out[::-1]


def compile_dictionary(tsv_path: str, out_path: str) -> str:
    """TSV source → compiled ``.npz`` (counts normalized to costs;
    the kuromoji-compile analog)."""
    return LatticeDictionary.from_tsv(tsv_path).save_compiled(out_path)


_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "data")
_bundled_cache: Dict[str, LatticeDictionary] = {}


def _bundled(name: str) -> LatticeDictionary:
    if name not in _bundled_cache:
        _bundled_cache[name] = LatticeDictionary.from_tsv(
            os.path.join(_DATA_DIR, f"{name}.tsv.gz"))
    d = _bundled_cache[name]
    # hand out a COPY: callers may .add() custom terms, and a shared
    # singleton would leak those into every later default factory
    return LatticeDictionary(d._cost, tags=d._tag, connections=d._conn)


def chinese_dictionary() -> LatticeDictionary:
    """The bundled ~65k-entry Chinese dictionary (derived from jieba's
    MIT-licensed frequency list; tools/build_zh_dictionary.py) — the
    ansj-language-pack analog: real text segments out of the box."""
    return _bundled("zh_core")


def japanese_dictionary() -> LatticeDictionary:
    """The bundled Japanese core dictionary (~560 curated morphemes:
    closed-class particles/auxiliaries + common content words + a
    tag-pair connection matrix) — the Kuromoji-language-pack analog,
    relying on character-class unknown grouping for open-class OOV."""
    return _bundled("ja_core")


def korean_dictionary() -> LatticeDictionary:
    """The bundled Korean core dictionary (~900 curated morphemes:
    josa particles + verb/adjective endings + common content words +
    a tag-pair connection matrix — tools/build_ko_dictionary.py).
    Korean eojeol split stem|josa / stem|ending; an out-of-dictionary
    stem groups as one hangul unknown run that ends where a known
    attachment begins (the reference wraps an external analyzer for
    this, deeplearning4j-nlp-korean/.../KoreanTokenizer.java:24-40 —
    here it is the same lattice that serves zh/ja)."""
    return _bundled("ko_core")


def small_cjk_dictionary() -> LatticeDictionary:
    """A small bundled dictionary (counts → costs) exercising the
    classic segmentation ambiguities. A real deployment loads a corpus
    dictionary through LatticeDictionary.from_counts; bundling a
    curated core mirrors the reference shipping ansj/Kuromoji dicts
    inside the language-pack jars."""
    counts = {
        # 研究生命起源: correct 研究|生命|起源, FMM says 研究生|命|起源
        "研究": 5000, "生命": 4000, "起源": 1500, "研究生": 600,
        "命": 800, "生": 900,
        # 北京大学生前来应聘: correct 北京|大学生|前来|应聘
        "北京": 8000, "大学生": 2000, "大学": 6000, "北京大学": 700,
        "生前": 300, "前来": 1200, "应聘": 900, "来": 5000,
        # common particles / words for Japanese examples
        "東京": 7000, "東京都": 2500, "都": 1000, "京都": 3000,
        "すもも": 200, "もも": 900, "も": 8000, "の": 20000,
        "うち": 1500,
    }
    return LatticeDictionary.from_counts(counts)


class LatticeCJKTokenizerFactory:
    """TokenizerFactory SPI plug-in: Viterbi-lattice segmentation for
    CJK runs (the Kuromoji-class replacement for the greedy
    CJKTokenizerFactory), DefaultTokenizerFactory for Latin text.

    ``dictionary``: a LatticeDictionary, a path to a ``.tsv``/
    ``.tsv.gz``/compiled ``.npz`` dictionary file, or a bundled
    language pack name (``"zh"`` — default — / ``"ja"`` / ``"ko"``).
    Out of the box this segments real Chinese with the 65k-entry
    bundled dictionary (reference parity: the ansj/Kuromoji packs
    ship inside the language-pack jars)."""

    def __init__(self, dictionary=None, *, unknown_cost: float = 12.0):
        if dictionary is None or dictionary == "zh":
            dictionary = chinese_dictionary()
        elif dictionary == "ja":
            dictionary = japanese_dictionary()
        elif dictionary == "ko":
            dictionary = korean_dictionary()
        elif isinstance(dictionary, (str, os.PathLike)):
            dictionary = LatticeDictionary.load(dictionary)
        self.segmenter = ViterbiSegmenter(dictionary,
                                          unknown_cost=unknown_cost)
        self._latin = DefaultTokenizerFactory()
        self._pre = None

    def set_token_pre_processor(self, pre):
        self._pre = pre
        return self

    def create(self, text: str) -> Tokenizer:
        tokens: List[str] = []
        latin: List[str] = []
        run: List[str] = []

        def flush_latin():
            if latin:
                tokens.extend(self._latin.create(
                    "".join(latin)).get_tokens())
                latin.clear()

        def flush_run():
            if run:
                tokens.extend(self.segmenter.segment("".join(run)))
                run.clear()

        for ch in text:
            if _is_cjk(ch):
                flush_latin()
                run.append(ch)
            else:
                flush_run()
                latin.append(ch)
        flush_latin()
        flush_run()
        return Tokenizer(tokens, self._pre)
