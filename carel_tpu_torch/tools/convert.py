"""Dataset conversion utilities; port of carel_tpu/tools/convert.py (host
only, byte-equal outputs).

- RECCON TSV blocks -> ECPE format, with the emotion-word mapping
  (en_dataset_conversion.py:8-23, :178-238);
- train -> test conversion: causes replaced with -1, emotions normalized to
  numeric codes (:248-284);
- zh json (doc dict with "class"/"len"/"content") -> per-category ECPE
  train/test files (cn_dataset_conversion.py:169-193), and the merge of
  such json datasets;
- BoW corpus concatenation (:240-246).
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Dict, List

from carel_tpu_torch.data.ecpe_format import EMOTION_TO_CODE, _HEADER_RE

# en_dataset_conversion.py:8-23 keys RECCON's emotion words to codes
RECCON_MAPPINGS = {w: str(c) for w, c in EMOTION_TO_CODE.items()}
RECCON_MAPPINGS.update({
    "happy": "0", "happines": "0", "excited": "0",
    "sad": "1", "frustrated": "1",
    "surprised": "3", "afraid": "4", "fearful": "4",
    "angry": "5", "neutral": "6",
})


def reccon_to_ecpe(file_path: str, target_path: str,
                   minusone: bool = False, bow_optimize: bool = False) -> None:
    """RECCON tab-separated blocks -> comma-separated ECPE format.

    minusone replaces the third field with -1 (the stage-1 placeholder);
    bow_optimize preserves token spacing (get_RECCON_emotions[_minusone]).
    """
    outputs: List[str] = []
    with open(file_path, encoding="utf8") as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not _HEADER_RE.search(line):
            continue
        outputs.append(line)
        doc_len = int(line.strip().split(" ")[1])
        outputs.append(lines[i])
        i += 1
        for _ in range(doc_len):
            elements = lines[i].strip().split("\t")
            i += 1
            sen_id, sen_emotion, emotion_label, utterance = (
                elements[0], elements[1], elements[2], elements[3])
            if not minusone and not bow_optimize:
                utterance = utterance.replace(",", "")
            elif minusone and not bow_optimize:
                utterance = utterance.replace(",", " ").replace(" ", "")
            sen_emotion = RECCON_MAPPINGS.get(sen_emotion, "0")
            if minusone:
                emotion_label = "-1"
            else:
                emotion_label = RECCON_MAPPINGS.get(emotion_label,
                                                    emotion_label)
            outputs.append(
                ",".join([sen_id, sen_emotion, emotion_label, utterance])
                + "\n")
    with open(target_path, "w", encoding="utf8") as f:
        f.writelines(outputs)


def convert_train_to_test(source: str, target: str,
                          bow_optimize: bool = False) -> str:
    """Gold train file -> test-format file: causes -> -1, emotions -> codes
    (convert_train_to_test, en_dataset_conversion.py:248-284)."""
    outputs: List[str] = []
    with open(source, encoding="utf8") as f:
        lines = f.readlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not _HEADER_RE.search(line):
            continue
        outputs.append(line)
        doc_len = int(line.strip().split(" ")[1])
        outputs.append(lines[i])
        i += 1
        for _ in range(doc_len):
            elements = lines[i].strip().split(",")
            i += 1
            sen_id, sen_emotion, _, utterance = (
                elements[0], elements[1], elements[2],
                ",".join(elements[3:]))
            if not bow_optimize:
                utterance = utterance.replace(",", " ").replace(" ", "")
                if sen_emotion not in set("0123456"):
                    sen_emotion = RECCON_MAPPINGS.get(sen_emotion, "0")
            else:
                sen_emotion = RECCON_MAPPINGS.get(sen_emotion, sen_emotion)
            outputs.append(
                ",".join([sen_id, sen_emotion, "-1", utterance]) + "\n")
    path = target.replace(".txt", "_optimize.txt") if bow_optimize else target
    with open(path, "w", encoding="utf8") as f:
        f.writelines(outputs)
    return path


def concat_bow_corpus(paths: List[str], target: str) -> None:
    """Concatenate ECPE corpora into one BoW source file
    (get_bow_en_file, en_dataset_conversion.py:240-246)."""
    lines: List[str] = []
    for p in paths:
        with open(p, encoding="utf8") as f:
            lines += f.readlines()
    with open(target, "w", encoding="utf8") as f:
        f.writelines(lines)


def json_to_ecpe_split(src_path: str, out_dir: str) -> Dict[str, List[str]]:
    """zh doc-dict json -> per-category {cat}.txt / {cat}_test.txt files
    (transform, cn_dataset_conversion.py:169-193). Test files keep the gold
    pair line but blank causes to -1. Returns category -> [train, test] paths.
    """
    with open(src_path, encoding="utf8") as f:
        data = json.load(f)
    train_out: Dict[str, List[str]] = defaultdict(list)
    test_out: Dict[str, List[str]] = defaultdict(list)
    for key, value in data.items():
        category = value["class"]
        content = [c if c.endswith("\n") else c + "\n"
                   for c in value["content"]]
        doc_len = value.get("len", len(content) - 1)
        header = f"{key} {doc_len}\n"
        train_out[category].extend([header] + content)
        test_lines = [header, content[0]]
        for sentence in content[1:]:
            tokens = sentence.split(",")
            tokens[2] = "-1"
            test_lines.append(",".join(tokens))
        test_out[category].extend(test_lines)

    os.makedirs(out_dir, exist_ok=True)
    written: Dict[str, List[str]] = {}
    for cat, lines in train_out.items():
        p_train = os.path.join(out_dir, f"{cat}.txt")
        with open(p_train, "w", encoding="utf8") as f:
            f.writelines(lines)
        p_test = os.path.join(out_dir, f"{cat}_test.txt")
        with open(p_test, "w", encoding="utf8") as f:
            f.writelines(test_out[cat])
        written[cat] = [p_train, p_test]
    return written


def merge_json_datasets(paths: List[str], target: str) -> Dict:
    """Merge doc-dict json datasets, re-keying duplicates (the non-interactive
    core of cn_dataset_merge.py)."""
    merged: Dict = {}
    next_id = 1
    for p in paths:
        with open(p, encoding="utf8") as f:
            data = json.load(f)
        for _, value in sorted(data.items(), key=lambda kv: int(kv[0])):
            merged[str(next_id)] = value
            next_id += 1
    with open(target, "w", encoding="utf8") as f:
        json.dump(merged, f, ensure_ascii=False, indent=1)
    return merged
