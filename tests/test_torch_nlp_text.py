"""The port's host-side text modules against the JAX package's, on the
CPU: the CJK lattice segmenter and its bundled dictionaries
(``nlp/lattice.py``, ``nlp/data/*.tsv.gz``), the annotators and the
Porter stemmer (``nlp/annotation.py``), the bag-of-words and TF-IDF
vectorizers and the ``.vec`` word-vector format (``nlp/serializer.py``).
These are copies of host code: every output is held EQUAL to the JAX
package's (token lists, spans, features, float32 arrays bit for bit),
except the ``.vec`` text, whose values are printed to 6 decimals (read
back within 5e-7).
"""

import filecmp
import os

import numpy as np
import pytest

from deeplearning4j_tpu.nlp import annotation as jann
from deeplearning4j_tpu.nlp import lattice as jlat
from deeplearning4j_tpu.nlp import serializer as jser
from deeplearning4j_tpu.nlp import tokenization as jtok
from deeplearning4j_tpu.nlp.word2vec import Word2Vec as JaxW2V
from deeplearning4j_tpu_torch.nlp import annotation as tann
from deeplearning4j_tpu_torch.nlp import lattice as tlat
from deeplearning4j_tpu_torch.nlp import serializer as tser
from deeplearning4j_tpu_torch.nlp import tokenization as ttok
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_nlp.py's segmentation cases, by language pack
SEGMENT_CASES = [
    ("zh", "研究生命起源", ["研究", "生命", "起源"]),
    ("zh", "北京大学生前来应聘", ["北京", "大学生", "前来", "应聘"]),
    ("zh", "我来到北京清华大学", ["我", "来到", "北京", "清华大学"]),
    ("zh", "今天天气很好", ["今天", "天气", "很", "好"]),
    ("zh", "自然语言处理很有趣", ["自然语言", "处理", "很", "有趣"]),
    ("zh", "hello 机器学习 world", None),
    ("zh", "コンピュータの研究", ["コンピュータ", "の", "研究"]),
    ("ja", "東京都の研究", ["東京都", "の", "研究"]),
    ("ja", "私は学生です", ["私", "は", "学生", "です"]),
    ("ja", "日本語を勉強しています", ["日本語", "を", "勉強", "して", "います"]),
    ("ja", "彼女は毎日コーヒーを飲みます",
     ["彼女", "は", "毎日", "コーヒー", "を", "飲みます"]),
    ("ko", "나는 학교에 갑니다", ["나", "는", "학교", "에", "갑니다"]),
    ("ko", "대학교에서 한국어를 공부합니다",
     ["대학교", "에서", "한국어", "를", "공부", "합니다"]),
    ("ko", "생명의 기원을 연구했습니다",
     ["생명", "의", "기원", "을", "연구", "했습니다"]),
    ("ko", "블록체인을 공부합니다", ["블록체인", "을", "공부", "합니다"]),
]


@pytest.mark.parametrize("lang,text,want", SEGMENT_CASES)
def test_lattice_segmentation_matches_jax(lang, text, want):
    got = tlat.LatticeCJKTokenizerFactory(lang).create(text).get_tokens()
    assert got == jlat.LatticeCJKTokenizerFactory(lang).create(
        text).get_tokens()
    if want is not None:
        assert got == want


@pytest.mark.parametrize("name", ["zh_core", "ja_core", "ko_core"])
def test_bundled_dictionaries_are_the_jax_packages(name):
    """The port keeps its own copy of each dictionary, byte for byte,
    and loads the same entries, costs, tags and connections."""
    tpath = os.path.join(REPO, "deeplearning4j_tpu_torch", "nlp", "data",
                         f"{name}.tsv.gz")
    jpath = os.path.join(REPO, "deeplearning4j_tpu", "nlp", "data",
                         f"{name}.tsv.gz")
    assert filecmp.cmp(tpath, jpath, shallow=False)
    td = tlat.LatticeDictionary.from_tsv(tpath)
    jd = jlat.LatticeDictionary.from_tsv(jpath)
    assert sorted(td.words()) == sorted(jd.words())
    assert len(list(td.words())) > 500
    rng = np.random.default_rng(0)
    words = sorted(jd.words())
    for w in (words[i] for i in rng.integers(0, len(words), 200)):
        assert td.cost(w) == jd.cost(w), w
        assert td.tag(w) == jd.tag(w), w


def test_default_packs_and_small_dictionary_match_jax():
    assert sorted(tlat.chinese_dictionary().words()) == \
        sorted(jlat.chinese_dictionary().words())
    assert sorted(tlat.korean_dictionary().words()) == \
        sorted(jlat.korean_dictionary().words())
    assert sorted(tlat.small_cjk_dictionary().words()) == \
        sorted(jlat.small_cjk_dictionary().words())


def test_custom_dictionary_and_connections_match_jax():
    counts = {"机器": 100, "学习": 120, "机器学习": 200}
    td = tlat.LatticeDictionary.from_counts(counts)
    jd = jlat.LatticeDictionary.from_counts(counts)
    text = "hello 机器学习 world"
    assert tlat.LatticeCJKTokenizerFactory(td).create(text).get_tokens() \
        == jlat.LatticeCJKTokenizerFactory(jd).create(text).get_tokens() \
        == ["hello", "机器学习", "world"]
    kw = dict(tags={"AB": "noun", "A": "prefix", "B": "noun", "C": "noun"},
              connections={("prefix", "noun"): -3.0})
    costs = {"AB": 1.0, "A": 1.0, "B": 1.0, "C": 1.0}
    for conn in (kw, {}):
        t = tlat.ViterbiSegmenter(tlat.LatticeDictionary(costs, **conn))
        j = jlat.ViterbiSegmenter(jlat.LatticeDictionary(costs, **conn))
        assert t.segment("ABC") == j.segment("ABC")
    assert tlat.ViterbiSegmenter(tlat.LatticeDictionary(costs, **kw)) \
        .segment("ABC") == ["A", "B", "C"]


def test_tsv_compile_round_trip_matches_jax(tmp_path):
    tsv = tmp_path / "d.tsv"
    tsv.write_text(
        "# test dict\n"
        "研究\t5000\tn\n生命\t4000\tn\n起源\t1500\tn\n"
        "研究生\t600\tn\n命\t800\tn\n生\t900\tn\n"
        "@conn\tn\tn\t-0.1\n", encoding="utf-8")
    td = tlat.LatticeDictionary.from_tsv(str(tsv))
    assert td.connection("n", "n") == -0.1
    tout = tlat.compile_dictionary(str(tsv), str(tmp_path / "t.npz"))
    jout = jlat.compile_dictionary(str(tsv), str(tmp_path / "j.npz"))
    text = "研究生命起源"
    # either package loads the other's compiled file
    for path in (tout, jout):
        assert tlat.ViterbiSegmenter(tlat.LatticeDictionary.load(path)) \
            .segment(text) == jlat.ViterbiSegmenter(
                jlat.LatticeDictionary.load(path)).segment(text) \
            == ["研究", "生命", "起源"]
    assert tlat.LatticeCJKTokenizerFactory(str(tsv)).create(
        text).get_tokens() == ["研究", "生命", "起源"]


def test_greedy_fmm_trap_as_in_jax():
    text = "研究生命起源"
    words = list(tlat.small_cjk_dictionary().words())
    assert ttok.CJKTokenizerFactory(dictionary=words).create(
        text).get_tokens() == jtok.CJKTokenizerFactory(
            dictionary=words).create(text).get_tokens() == \
        ["研究生", "命", "起源"]


DOC = ("Dr. Smith was running quickly. The experiments continued! "
       "Results were encouraging. Mrs. Jones, e.g. the agreed owner, "
       "said: \"hopefulness\" and relational conflated ponies?")


def _spans(doc, kind):
    return [(a.begin, a.end, a.type, dict(a.features))
            for a in doc.select(kind)]


def test_annotator_pipeline_matches_jax():
    tp = tann.AnnotatorPipeline([tann.SentenceAnnotator(),
                                 tann.TokenizerAnnotator(),
                                 tann.StemmerAnnotator()])
    jp = jann.AnnotatorPipeline([jann.SentenceAnnotator(),
                                 jann.TokenizerAnnotator(),
                                 jann.StemmerAnnotator()])
    td, jd = tp.annotate(DOC), jp.annotate(DOC)
    assert td.text == jd.text
    for kind in ("sentence", "token"):
        assert _spans(td, kind) == _spans(jd, kind)
    sents = td.select("sentence")
    assert sents[0].covered_text(td.text).startswith("Dr. Smith")
    assert [t.covered_text(td.text) for t in td.covered(sents[0], "token")] \
        == [t.covered_text(jd.text)
            for t in jd.covered(jd.select("sentence")[0], "token")]


PORTER = [("caresses", "caress"), ("ponies", "poni"), ("agreed", "agre"),
          ("plastered", "plaster"), ("motoring", "motor"),
          ("happy", "happi"), ("relational", "relat"),
          ("conflated", "conflat"), ("hopefulness", "hope"),
          ("running", "run"), ("experiments", "experi"), ("sky", "sky"),
          ("generalizations", "gener"), ("a", "a")]


@pytest.mark.parametrize("word,stem", PORTER)
def test_porter_stem_matches_jax(word, stem):
    assert tann.porter_stem(word) == jann.porter_stem(word) == stem


def test_porter_stem_vocabulary_matches_jax():
    words = {w for s in [DOC] + [" ".join(d) for d in [
        ["generously", "hesitancy", "digitizer", "conformabli",
         "radicalli", "differentli", "vileli", "analogousli",
         "vietnamization", "predication", "operator", "feudalism",
         "decisiveness", "callousness", "formaliti", "sensitiviti",
         "sensibiliti", "triplicate", "formative", "formalize",
         "electriciti", "electrical", "hopeful", "goodness",
         "revival", "allowance", "inference", "airliner",
         "gyroscopic", "adjustable", "defensible", "irritant",
         "replacement", "adjustment", "dependent", "adoption",
         "homologou", "communism", "activate", "angulariti",
         "homologous", "effective", "bowdlerize", "probate", "rate",
         "cease", "controll", "roll", "feed", "filing", "sized"]]]
        for w in s.split()}
    for w in sorted(words):
        w = w.strip(".,!?:\"").lower()
        assert tann.porter_stem(w) == jann.porter_stem(w), w


@pytest.mark.parametrize("stems", [False, True])
def test_annotation_tokenizer_factory_matches_jax(stems):
    t = tann.AnnotationTokenizerFactory(use_stems=stems)
    j = jann.AnnotationTokenizerFactory(use_stems=stems)
    for text in ("The cats sat.", "The cats were running.", DOC, ""):
        assert t.create(text).get_tokens() == j.create(text).get_tokens()
    fk = tann.AnnotationTokenizerFactory(tann.AnnotatorPipeline([
        tann.SentenceAnnotator(),
        tann.TokenizerAnnotator(tlat.LatticeCJKTokenizerFactory())]))
    assert fk.create("研究生命起源。").get_tokens() == \
        ["研究", "生命", "起源"]


def test_bow_and_tfidf_match_jax():
    docs = [["a", "b", "a"], ["b", "c"], ["c", "c", "c"], ["d", "a", "zz"]]
    for min_freq in (1, 2):
        tb = tser.BagOfWordsVectorizer(min_freq)
        jb = jser.BagOfWordsVectorizer(min_freq)
        np.testing.assert_array_equal(tb.fit_transform(docs),
                                      jb.fit_transform(docs))
        tt = tser.TfidfVectorizer(min_freq).fit(docs)
        jt = jser.TfidfVectorizer(min_freq).fit(docs)
        np.testing.assert_array_equal(tt.idf, jt.idf)
        for d in docs + [["a", "b"], [], ["zz", "q"]]:
            np.testing.assert_array_equal(tt.transform(d), jt.transform(d))
    v2 = tser.TfidfVectorizer().fit(docs).transform(["a", "b"])
    vocab = tser.TfidfVectorizer().fit(docs).vocab
    assert v2[vocab.index_of("a")] > 0 and v2.dtype == np.float32


def test_word_vectors_round_trip_read_by_both_packages(tmp_path):
    corpus = [" ".join(s) for s in [["apple", "banana", "cherry"],
                                    ["cpu", "gpu", "ram"]] * 20]
    w = (Word2Vec.builder().iterate(corpus).layer_size(16)
         .min_word_frequency(1).epochs(1).seed(0).device("cpu").build())
    w.fit()
    tpath, jpath = str(tmp_path / "t.vec"), str(tmp_path / "j.vec")
    tser.write_word_vectors(w, tpath)
    jw = JaxW2V.builder().iterate(corpus).layer_size(16) \
        .min_word_frequency(1).epochs(1).seed(0).build()
    jw.fit()
    jw.syn0 = w.syn0                    # the same table through each writer
    jser.write_word_vectors(jw, jpath)
    assert open(tpath).read() == open(jpath).read()
    for read in (tser.read_word_vectors, jser.read_word_vectors):
        cache, vecs = read(tpath)
        assert [x.word for x in cache.words] == \
            [x.word for x in w.vocab.words]
        np.testing.assert_allclose(vecs, w.syn0, atol=5e-7, rtol=0)
    tc, tv = tser.read_word_vectors(tpath)
    jc, jv = jser.read_word_vectors(tpath)
    np.testing.assert_array_equal(tv, jv)
    assert tv.dtype == np.float32
