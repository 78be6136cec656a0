"""The port's ingest (carel_tpu_torch.data) against carel_tpu.data on a
synthetic zh ECPE corpus: Documents, PairSet, BowVocab and PairArrays must be
exactly equal. Also the sklearn-free vocabulary construction against sklearn's
CountVectorizer."""

import dataclasses
import os
import random

import numpy as np
import pytest

import carel_tpu.data as jdata
from carel_tpu.data.batching import encode_pairs as j_encode_pairs
from carel_tpu.data.tokenizer import ZhCharTokenizer as JZhCharTokenizer

import carel_tpu_torch.data as tdata
from carel_tpu_torch.data import bow as tbow
from carel_tpu_torch.data.batching import encode_pairs as t_encode_pairs
from carel_tpu_torch.data.tokenizer import ZhCharTokenizer as TZhCharTokenizer

WORDS = ["我们", "今天", "很", "高兴", "因为", "考试", "成绩", "好", "老师",
         "表扬", "了", "学生", "家长", "感到", "骄傲", "他", "伤心", "难过",
         "生气", "害怕", "惊讶", "孩子", "学校", "作业", "朋友", "一起", "回家",
         "吃饭", "看书", "写字", "妈妈", "哭", "笑", "病", "失败", "成功"]


def _clause_text(rng) -> str:
    n = int(rng.integers(2, 7))
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), n)]
    # the corpora separate tokens with spaces; keep some unspaced too
    return (" " if rng.random() < 0.7 else "").join(words)


# English clauses: capitals, accents, apostrophes, punctuation glued to
# words, digits and commas (which cut the reference's clause field 3)
EN_WORDS = ["She", "was", "very", "happy", "because", "the", "exam", "went",
            "well", "teacher", "praised", "him", "Parents", "felt", "proud",
            "sad", "angry", "afraid", "surprised", "café", "naïve", "Résumé",
            "didn't", "won't", "children's", "school,", "homework!", "why?",
            "friends", "together", "home.", "dinner", "mother", "cried",
            "laughed", "ill", "failed", "succeeded", "1999", "twenty-one",
            "(again)", "\"no\"", "rain;", "Über", "façade", "it's"]


def _en_clause_text(rng) -> str:
    n = int(rng.integers(3, 12))
    return " ".join(EN_WORDS[i] for i in rng.integers(0, len(EN_WORDS), n))


def synth_docs(seed: int, n_docs: int, predicted: bool = False,
               language: str = "zh"):
    """Documents with one or two gold pairs each. ``predicted`` mimics a
    stage-1 file: some gold emotion clauses are predicted null (forced
    misses) and some null clauses are predicted as emotions. en documents
    carry English clauses and their emotions as words, as the en corpora
    do."""
    rng = np.random.default_rng(seed)
    docs = []
    for d in range(n_docs):
        n = int(rng.integers(3, 9))
        emo = int(rng.integers(1, n + 1))
        cau = int(np.clip(emo + rng.integers(-2, 2), 1, n))
        pairs = [(emo, cau)]
        if n >= 5 and rng.random() < 0.3:
            pairs.append((emo, int(rng.integers(1, n + 1))))
        pairs = list(dict.fromkeys(pairs))
        emotion = {s: 6 for s in range(1, n + 1)}
        emotion[emo] = int(rng.integers(0, 6))
        if predicted:
            if rng.random() < 0.2:
                emotion[emo] = 6  # stage 1 missed this emotion
            if rng.random() < 0.3:
                extra = int(rng.integers(1, n + 1))
                if extra != emo:
                    emotion[extra] = int(rng.integers(0, 6))
        clauses = []
        for s in range(1, n + 1):
            if language == "zh":
                text, raw = _clause_text(rng), str(emotion[s])
            else:
                text = _en_clause_text(rng)
                raw = tdata.ecpe_format.CODE_TO_EMOTION[emotion[s]]
            clauses.append(tdata.Clause(
                sen_id=s, emotion=emotion[s], cause=-1 if predicted else 6,
                text=text, emotion_raw=raw,
                cause_raw="-1" if predicted else "6",
                text_field3=text.split(",")[0]))
        docs.append(tdata.Document(doc_id=str(d + 1), pairs=pairs,
                                   clauses=clauses))
    return docs


def write_newsplit_corpus(root: str, seed: int = 0, n_train: int = 24,
                          n_test: int = 16) -> None:
    """The zh newsplit layout that pipeline.resolve_paths expects for the
    flagship preset (home -> education)."""
    paths = {
        "data/ECPE_new_dataset/home.txt": synth_docs(seed, n_train),
        "pair_data/predicted_emotion/source_home/education.txt":
            synth_docs(seed + 1, n_test, predicted=True),
    }
    paths["data/all_data_pair_zh.txt"] = (
        paths["data/ECPE_new_dataset/home.txt"]
        + synth_docs(seed + 2, n_train))
    for rel, docs in paths.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tdata.write_ecpe_file(path, docs)


def write_oldsplit_corpus(root: str, seed: int = 0, n_train: int = 24,
                          n_test: int = 16) -> None:
    """The zh old-split layout that pipeline.resolve_paths expects for the
    old-split presets: ec_hsic, ec_none, ec_final_mul, ec_mmd_final_mul and
    ec_vi_final (society_num -> education), ec_gan (society -> education)
    and ec_mmd_self_chain (society -> entertainment, both sides from
    THUCTC_multiple with gold emotions); and the original verb's society ->
    pair_data/emotion/finance.txt."""
    train = synth_docs(seed, n_train)
    paths = {
        "domains/THUCTC_multiple/society_num.txt": train,
        "domains/THUCTC_multiple/society.txt": train,
        "domains/THUCTC_multiple/entertainment.txt":
            synth_docs(seed + 3, n_test),
        "pair_data/emotion/education.txt":
            synth_docs(seed + 1, n_test, predicted=True),
        "pair_data/emotion/finance.txt":
            synth_docs(seed + 4, n_test, predicted=True),
        "data/all_data_pair_zh.txt": train + synth_docs(seed + 2, n_train),
    }
    for rel, docs in paths.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tdata.write_ecpe_file(path, docs)


def write_en_corpus(root: str, seed: int = 0, n_train: int = 24,
                    n_test: int = 16) -> None:
    """The en layouts that pipeline.resolve_paths expects: en_newsplit
    (enecpe_num -> the stage-1-predicted reccon_test, with its BoW file),
    drl_en (history_num -> pair_data/emotion/war_new, with its BoW file),
    and domains/Englishnovel_multiple/{home,education}.txt for the stage1
    verb's --language en (and the dann verb's --doc_dir)."""
    def en(s, n, predicted=False):
        return synth_docs(s, n, predicted, language="en")

    train = en(seed, n_train)
    paths = {
        "domains/Englishnovel_multiple/enecpe_num.txt": train,
        "pair_data/predicted_emotion/source_enecpe_num/reccon_test.txt":
            en(seed + 1, n_test, predicted=True),
        "data/ecpe_and_reccon_all_data_pair_en.txt":
            train + en(seed + 2, n_train),
        "domains/Englishnovel_multiple/history_num.txt": en(seed + 3,
                                                            n_train),
        "pair_data/emotion/war_new.txt": en(seed + 4, n_test,
                                            predicted=True),
        "data/all_data_pair_en.txt": en(seed + 3, n_train)
        + en(seed + 5, n_train),
        "domains/Englishnovel_multiple/home.txt": en(seed + 6, n_train),
        "domains/Englishnovel_multiple/education.txt": en(seed + 7, n_test),
    }
    for rel, docs in paths.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tdata.write_ecpe_file(path, docs, pair_style="en")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zh_corpus"))
    write_newsplit_corpus(root)
    return root


def _paths(root):
    return (os.path.join(root, "data/ECPE_new_dataset/home.txt"),
            os.path.join(root,
                         "pair_data/predicted_emotion/source_home/education.txt"),
            os.path.join(root, "data/all_data_pair_zh.txt"))


def _asdicts(xs):
    return [dataclasses.asdict(x) for x in xs]


def test_documents_equal(corpus):
    for path in _paths(corpus):
        assert _asdicts(tdata.parse_ecpe_file(path)) == \
            _asdicts(jdata.parse_ecpe_file(path))


@pytest.mark.parametrize("test_mode", [False, True])
def test_pair_sets_equal(corpus, test_mode):
    path = _paths(corpus)[1 if test_mode else 0]
    t = tdata.build_pairs(tdata.parse_ecpe_file(path), test=test_mode,
                          rng=random.Random(42))
    j = jdata.build_pairs(jdata.parse_ecpe_file(path), test=test_mode,
                          rng=random.Random(42))
    assert len(t) > 0
    assert _asdicts(t.examples) == _asdicts(j.examples)
    assert t.docs_pair_size == j.docs_pair_size
    assert t.num_unpred_emotions == j.num_unpred_emotions
    if test_mode:
        assert t.num_unpred_emotions > 0


def test_bow_vocab_zh_equals_sklearn_build(corpus):
    bow_path = _paths(corpus)[2]
    t = tdata.build_bow_vocab_zh(bow_path)
    j = jdata.build_bow_vocab_zh(bow_path)
    assert len(t) > 10
    assert t.words == j.words
    assert t.index == j.index


@pytest.mark.parametrize("tokenizer", [None, "zh"])
def test_count_vectorizer_vocab_matches_sklearn(tokenizer):
    from sklearn.feature_extraction.text import CountVectorizer

    corpus = ["The quick brown Fox, the LAZY dog!", "a b cd e_f 12 x1 Ünïcode",
              "don't stop-believing; ÉTÉ été", "我们今天很高兴", "I a"]
    tok = tbow.tokenize_zh if tokenizer == "zh" else None
    vec = (CountVectorizer(tokenizer=tok, token_pattern=None) if tok
           else CountVectorizer())
    vec.fit(corpus)
    assert tbow._count_vectorizer_vocab(corpus, tok) == \
        list(vec.get_feature_names_out())


def test_pair_arrays_equal(corpus):
    train_path, test_path, bow_path = _paths(corpus)
    texts = [c.text for d in tdata.parse_ecpe_file(bow_path)
             for c in d.clauses]
    t_tok = TZhCharTokenizer.from_corpus(texts)
    j_tok = JZhCharTokenizer.from_corpus(texts)
    assert t_tok.vocab == j_tok.vocab
    t_bow = tdata.build_bow_vocab_zh(bow_path)
    j_bow = jdata.build_bow_vocab_zh(bow_path)
    for path, test_mode in ((train_path, False), (test_path, True)):
        t_pairs = tdata.build_pairs(tdata.parse_ecpe_file(path),
                                    test=test_mode, rng=random.Random(7))
        j_pairs = jdata.build_pairs(jdata.parse_ecpe_file(path),
                                    test=test_mode, rng=random.Random(7))
        t_arr = t_encode_pairs(t_pairs, t_tok, t_bow, 48)
        j_arr = j_encode_pairs(j_pairs, j_tok, j_bow, 48)
        for f in dataclasses.fields(j_arr):
            a, b = getattr(t_arr, f.name), getattr(j_arr, f.name)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        assert (t_arr.bow_indices >= 0).any()
