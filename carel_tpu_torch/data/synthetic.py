"""Seeded synthetic ECPE corpora in the layouts ``pipeline.resolve_paths``
reads, and the committed zh segmentation cache of the zh one.

``write_zh_newsplit_corpus`` writes the flagship's layout
(``ec_mmd_final_mul_newsplit_emnlp``, home -> education):
``data/ECPE_new_dataset/home.txt``, the stage-1-predicted
``pair_data/predicted_emotion/source_home/education.txt`` and the BoW corpus
``data/all_data_pair_zh.txt``; ``write_en_newsplit_corpus`` writes
``en_newsplit``'s (enecpe_num -> reccon_test). Both come from
``write_ecpe_file`` over documents drawn from a numpy generator, so one seed
gives the same bytes on every machine.

``fixtures/`` holds the zh segmentation cache of the default zh corpus (the
flagship's train, test and BoW files), made where jieba imports:

    python -m carel_tpu_torch.data.synthetic

``install_zh_fixture(root, cache_dir)`` writes that corpus under ``root``
and copies the cache into ``cache_dir``, so that the zh verbs run where
jieba does not import.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import List

import numpy as np

from carel_tpu_torch.data.ecpe_format import (CODE_TO_EMOTION, Clause,
                                              Document, write_ecpe_file)

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures")

ZH_WORDS = ["我们", "今天", "很", "高兴", "因为", "考试", "成绩", "好", "老师",
            "表扬", "了", "学生", "家长", "感到", "骄傲", "他", "伤心", "难过",
            "生气", "害怕", "惊讶", "孩子", "学校", "作业", "朋友", "一起",
            "回家", "吃饭", "看书", "写字", "妈妈", "哭", "笑", "病", "失败",
            "成功", "电脑", "比赛", "冠军", "担心", "同学", "毕业", "工作",
            "城市", "医院", "医生", "礼物", "生日"]
EN_WORDS = ["She", "was", "very", "happy", "because", "the", "exam", "went",
            "well", "teacher", "praised", "him", "Parents", "felt", "proud",
            "sad", "angry", "afraid", "surprised", "didn't", "won't",
            "children's", "school,", "homework!", "why?", "friends",
            "together", "home.", "dinner", "mother", "cried", "laughed",
            "ill", "failed", "succeeded", "1999", "twenty-one", "rain;",
            "it's", "game", "won", "lost", "worried", "city"]

# the default corpora: documents of 3-8 clauses
ZH_SEED, ZH_TRAIN_DOCS, ZH_TEST_DOCS, ZH_EXTRA_DOCS = 0, 160, 48, 32
EN_SEED, EN_TRAIN_DOCS, EN_TEST_DOCS = 0, 160, 48


def _clause_text(rng, language: str) -> str:
    if language == "zh":
        words = [ZH_WORDS[i] for i in
                 rng.integers(0, len(ZH_WORDS), int(rng.integers(2, 7)))]
        # the corpora separate words with spaces; keep some unspaced too
        return (" " if rng.random() < 0.7 else "").join(words)
    return " ".join(EN_WORDS[i] for i in
                    rng.integers(0, len(EN_WORDS), int(rng.integers(3, 12))))


def synth_docs(seed: int, n_docs: int, predicted: bool = False,
               language: str = "zh") -> List[Document]:
    """Documents of 3-8 clauses with one or two gold pairs each.
    ``predicted`` mimics a stage-1 file: some gold emotion clauses are
    predicted null (forced misses), some null clauses predicted as
    emotions."""
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
            text = _clause_text(rng, language)
            raw = (str(emotion[s]) if language == "zh"
                   else CODE_TO_EMOTION[emotion[s]])
            clauses.append(Clause(
                sen_id=s, emotion=emotion[s], cause=-1 if predicted else 6,
                text=text, emotion_raw=raw,
                cause_raw="-1" if predicted else "6",
                text_field3=text.split(",")[0]))
        docs.append(Document(doc_id=str(d + 1), pairs=pairs,
                             clauses=clauses))
    return docs


def _write(root: str, paths: dict, pair_style: str) -> None:
    for rel, docs in paths.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_ecpe_file(path, docs, pair_style=pair_style)


def write_zh_newsplit_corpus(root: str, seed: int = ZH_SEED,
                             n_train: int = ZH_TRAIN_DOCS,
                             n_test: int = ZH_TEST_DOCS,
                             n_extra: int = ZH_EXTRA_DOCS) -> None:
    """The flagship's zh newsplit layout (home -> education) under
    ``root``."""
    train = synth_docs(seed, n_train)
    _write(root, {
        "data/ECPE_new_dataset/home.txt": train,
        "pair_data/predicted_emotion/source_home/education.txt":
            synth_docs(seed + 1, n_test, predicted=True),
        "data/all_data_pair_zh.txt": train + synth_docs(seed + 2, n_extra),
    }, "zh")


def write_en_newsplit_corpus(root: str, seed: int = EN_SEED,
                             n_train: int = EN_TRAIN_DOCS,
                             n_test: int = EN_TEST_DOCS) -> None:
    """``en_newsplit``'s layout (enecpe_num -> the stage-1-predicted
    reccon_test, with its BoW corpus) under ``root``."""
    train = synth_docs(seed, n_train, language="en")
    _write(root, {
        "domains/Englishnovel_multiple/enecpe_num.txt": train,
        "pair_data/predicted_emotion/source_enecpe_num/reccon_test.txt":
            synth_docs(seed + 1, n_test, predicted=True, language="en"),
        "data/ecpe_and_reccon_all_data_pair_en.txt":
            train + synth_docs(seed + 2, n_train // 4, language="en"),
    }, "en")


def zh_fixture_files(root: str) -> tuple:
    """The flagship's (train, test, BoW) paths under ``root``, the files
    its segmentation cache is keyed by."""
    return (os.path.join(root, "data/ECPE_new_dataset/home.txt"),
            os.path.join(root, "pair_data/predicted_emotion/source_home/"
                               "education.txt"),
            os.path.join(root, "data/all_data_pair_zh.txt"))


def fixture_cache_path() -> str:
    """The committed segmentation cache of the default zh corpus."""
    with tempfile.TemporaryDirectory() as root:
        write_zh_newsplit_corpus(root)
        from carel_tpu_torch.data.bow import segmentation_cache_path

        name = os.path.basename(segmentation_cache_path(
            "", zh_fixture_files(root)))
    return os.path.join(FIXTURE_DIR, name)


def install_zh_fixture(root: str, cache_dir: str) -> str:
    """Write the default zh corpus under ``root`` and copy its committed
    segmentation cache into ``cache_dir``; returns the cache's path
    there."""
    write_zh_newsplit_corpus(root)
    src = fixture_cache_path()
    os.makedirs(cache_dir, exist_ok=True)
    dst = os.path.join(cache_dir, os.path.basename(src))
    shutil.copyfile(src, dst)
    return dst


def make_zh_fixture_cache() -> str:
    """Segment the default zh corpus with jieba through the flagship's
    pipeline and write its cache into ``fixtures/``, replacing the old
    one; returns its path."""
    from carel_tpu_torch.config import PRESETS
    from carel_tpu_torch.data.bow import _import_jieba
    from carel_tpu_torch.models.encoder import tiny_encoder_config
    from carel_tpu_torch.pipeline import build_pipeline

    if _import_jieba() is None:
        raise SystemExit("jieba does not import here: make the cache where "
                         "it does")
    import dataclasses

    with tempfile.TemporaryDirectory() as tmp:
        root, cache = os.path.join(tmp, "data"), os.path.join(tmp, "cache")
        write_zh_newsplit_corpus(root)
        cfg = PRESETS["ec_mmd_final_mul_newsplit_emnlp"]
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, data_root=root))
        build_pipeline(cfg, cache_dir=cache,
                       encoder_cfg=tiny_encoder_config())
        made = [f for f in os.listdir(cache)
                if f.startswith("segmentation_zh_")]
        os.makedirs(FIXTURE_DIR, exist_ok=True)
        for old in os.listdir(FIXTURE_DIR):
            if old.startswith("segmentation_zh_"):
                os.remove(os.path.join(FIXTURE_DIR, old))
        dst = os.path.join(FIXTURE_DIR, made[0])
        shutil.copyfile(os.path.join(cache, made[0]), dst)
    return dst


if __name__ == "__main__":
    print(make_zh_fixture_cache())
