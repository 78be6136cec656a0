"""ECPE block text format: typed parser and writer.

The format (used by every file under the reference's data/, domains/ and
pair_data/ trees; consumed by read_ECPE_data, e.g.
the reference drl_classifier_ec_mmd_final_mul.py:631-731):

    <doc_id> <doc_len>
    <gold pair line>          e.g. zh: " (7,9)" or "(3,2), (5,4)"; en: "(2, 2),"
    <sen_id>,<emotion>,<cause>,<clause text>     x doc_len

Emotion / cause fields are either numeric codes (0..6, 6 = null; -1 for
"no cause" in stage-1 outputs) or English words (happiness/sadness/disgust/
surprise/fear/anger/null — mapping at en_dataset_conversion.py:8-23).

Unlike the reference (which `eval()`s the pair line), pairs are parsed with a
regex; documents become typed records instead of pandas rows.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

# Header: a 1-4 digit doc id, whitespace, a 1-2 digit doc length. The reference
# matches with re.search (flagship :640), i.e. anywhere in the line.
_HEADER_RE = re.compile(r"[0-9]{1,4}\s[0-9]{1,2}")
_PAIR_RE = re.compile(r"\((\d+)\s*,\s*(\d+)\)")

# en_dataset_conversion.py:8-23
EMOTION_TO_CODE = {
    "happiness": 0,
    "sadness": 1,
    "disgust": 2,
    "surprise": 3,
    "fear": 4,
    "anger": 5,
    "null": 6,
}
CODE_TO_EMOTION = {v: k for k, v in EMOTION_TO_CODE.items()}
NULL_EMOTION = 6


def parse_emotion_field(raw: str) -> int:
    """Map an emotion/cause field (numeric code or English word) to a code.

    Mirrors ECPE_Dataset's branching (baseline_emotion_classifier_final_devin.py
    :193-231). Unknown strings map to the null class; '-1' (stage-1 "no cause")
    is preserved as -1.
    """
    raw = raw.strip()
    if raw in EMOTION_TO_CODE:
        return EMOTION_TO_CODE[raw]
    try:
        val = int(raw)
    except ValueError:
        return NULL_EMOTION
    if val == -1:
        return -1
    if 0 <= val <= 6:
        return val
    return NULL_EMOTION


@dataclass
class Clause:
    sen_id: int  # 1-based position in the document
    emotion: int  # 0..6 (6 = null)
    cause: int  # 0..6, or -1 (stage-1 placeholder)
    text: str  # full clause text (token spacing preserved)
    emotion_raw: str = ""
    cause_raw: str = ""
    # The reference extracts clause text as `line.split(",")[3]` (flagship
    # :713, :725) which truncates at any comma inside the clause. Kept for
    # bit-parity with the reference's pair-text construction.
    text_field3: str = ""


@dataclass
class Document:
    doc_id: str
    pairs: List[Tuple[int, int]]  # gold (emotion_sen_id, cause_sen_id), 1-based
    clauses: List[Clause] = field(default_factory=list)

    @property
    def doc_len(self) -> int:
        return len(self.clauses)

    def clause(self, sen_id: int) -> Clause:
        return self.clauses[sen_id - 1]


def _parse_pairs(line: str) -> List[Tuple[int, int]]:
    return [(int(m.group(1)), int(m.group(2))) for m in _PAIR_RE.finditer(line)]


def parse_ecpe_text(text: str) -> List[Document]:
    """Parse ECPE block format from a string."""
    lines = text.split("\n")
    docs: List[Document] = []
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        i += 1
        if not line.strip():
            continue
        if not _HEADER_RE.search(line):
            continue
        head = line.strip().split()
        doc_id, doc_len = head[0], int(head[1])
        if i >= n:
            break
        pairs = _parse_pairs(lines[i])
        i += 1
        clauses: List[Clause] = []
        for _ in range(doc_len):
            if i >= n:
                break
            raw = lines[i].strip()
            parts = raw.split(",")
            # clause text may itself contain commas: fields are
            # sen_id, emotion, cause, text...
            try:
                sen_id = int(parts[0])
            except ValueError:
                # truncated/malformed document: stop consuming clause lines so
                # the next header is re-synced instead of crashing
                break
            i += 1
            emotion_raw = parts[1].strip()
            cause_raw = parts[2].strip()
            text_part = ",".join(parts[3:])
            # the reference later strips leading/trailing space per use site;
            # keep the raw text here
            clauses.append(
                Clause(
                    sen_id=sen_id,
                    emotion=parse_emotion_field(emotion_raw),
                    cause=parse_emotion_field(cause_raw),
                    text=text_part,
                    emotion_raw=emotion_raw,
                    cause_raw=cause_raw,
                    text_field3=parts[3] if len(parts) > 3 else "",
                )
            )
        docs.append(Document(doc_id=doc_id, pairs=pairs, clauses=clauses))
    return docs


def parse_ecpe_file(path: str) -> List[Document]:
    with open(path, encoding="utf8") as f:
        return parse_ecpe_text(f.read())


def write_ecpe_file(
    path: str,
    docs: Sequence[Document],
    pair_style: str = "zh",
) -> None:
    """Write documents back in the block format.

    pair_style 'zh' writes "(7,9), (3,2)"; 'en' writes "(7, 9), (3, 2),"
    matching the two corpora flavours. Used by the stage-1 pair-file writer
    (cf. generate_pair_data, baseline_emotion_classifier_final_devin.py:89-104).
    """
    with open(path, "w", encoding="utf8") as g:
        for doc in docs:
            g.write(f"{doc.doc_id} {doc.doc_len}\n")
            if pair_style == "en":
                g.write(", ".join(f"({e}, {c})" for e, c in doc.pairs) + ",\n"
                        if doc.pairs else "\n")
            else:
                g.write(", ".join(f"({e},{c})" for e, c in doc.pairs) + "\n")
            for cl in doc.clauses:
                emo = cl.emotion_raw if cl.emotion_raw else str(cl.emotion)
                cau = cl.cause_raw if cl.cause_raw else str(cl.cause)
                g.write(f"{cl.sen_id}, {emo}, {cau}, {cl.text}\n")



def split_raw_corpus(path: str, language: str) -> List[str]:
    """Split a plain-text (non-ECPE) file into clause-sized sentence
    segments, the ``pretrain`` verb's ``--raw_corpus``: zh splits on CJK
    sentence punctuation and strips spaces, keeping segments of 4 chars or
    more; en splits on [.!?;] followed by whitespace, keeping segments of 3
    words or more."""
    zh = language == "zh"
    splitter = r"[。！？；]" if zh else r"[.!?;]\s+"
    out: List[str] = []
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            for seg in re.split(splitter, line):
                seg = seg.strip()
                if zh:
                    seg = seg.replace(" ", "")
                    if len(seg) >= 4:
                        out.append(seg)
                elif len(seg.split()) >= 3:
                    out.append(seg)
    return out
