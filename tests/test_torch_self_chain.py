"""The port's self-chain pair construction (carel_tpu_torch.data.self_chain)
against carel_tpu.data.self_chain on a synthetic zh corpus: documents with
one emotion == cause pair, documents with two, documents whose zip over
(deduplicated emotions, causes) meets one only by the quirk, and documents
with none. Both parsers read the same file; the doc ids (duplicates
included), and the PairSets of train and test mode drawn with the same
``random.Random`` seed, must be exactly equal."""

import dataclasses
import random

import numpy as np
import pytest

from carel_tpu.data.ecpe_format import parse_ecpe_file as j_parse
from carel_tpu.data.self_chain import build_pairs_self_chain as j_build
from carel_tpu.data.self_chain import self_chain_doc_ids as j_doc_ids

import carel_tpu_torch.data as tdata
from carel_tpu_torch.data.self_chain import build_pairs_self_chain
from carel_tpu_torch.data.self_chain import self_chain_doc_ids
from tests.test_torch_data import _clause_text

# gold pairs per document, and its clause count
PAIRS = [
    ([(2, 2)], 5),  # one e == c pair
    ([(3, 1)], 6),  # none
    ([(2, 2), (4, 4)], 7),  # two: the doc id appears twice
    ([(3, 3), (3, 5)], 6),  # one e == c, a second cause of that emotion
    ([(4, 2), (4, 4)], 6),  # e == c second: the zip (4, 2) misses it
    ([(1, 2), (5, 5)], 8),  # two emotions, the second self-caused
    ([(6, 4)], 9),  # none
    ([(1, 1)], 3),  # one, in a short document
]


def _docs(seed=0):
    rng = np.random.default_rng(seed)
    docs = []
    for d, (pairs, n) in enumerate(PAIRS * 2):
        emotion = {s: 6 for s in range(1, n + 1)}
        for e, _ in pairs:
            emotion[e] = int(rng.integers(0, 6))
        clauses = []
        for s in range(1, n + 1):
            text = _clause_text(rng)
            clauses.append(tdata.Clause(
                sen_id=s, emotion=emotion[s], cause=6, text=text,
                emotion_raw=str(emotion[s]), cause_raw="6",
                text_field3=text))
        docs.append(tdata.Document(doc_id=str(d + 1), pairs=list(pairs),
                                   clauses=clauses))
    return docs


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("self_chain") / "society.txt")
    tdata.write_ecpe_file(path, _docs())
    return path


def test_self_chain_doc_ids_equal_jax(corpus):
    got = self_chain_doc_ids(tdata.parse_ecpe_file(corpus))
    assert got == j_doc_ids(j_parse(corpus))
    # per PAIRS, twice over: docs 1, 3 (twice), 4, 6; doc 5 is the zip miss
    assert got == ["1", "3", "3", "4", "6", "8",
                   "9", "11", "11", "12", "14", "16"]


@pytest.mark.parametrize("test_mode", [False, True])
def test_build_pairs_self_chain_equal_jax(corpus, test_mode):
    """Train then test mode from one rng each side, as the pipeline draws
    them; the rng is left in the same state."""
    t_rng, j_rng = random.Random(42), random.Random(42)
    t_docs, j_docs = tdata.parse_ecpe_file(corpus), j_parse(corpus)
    if test_mode:  # the train draws come first, as in build_pipeline
        build_pairs_self_chain(t_docs, test=False, rng=t_rng)
        j_build(j_docs, test=False, rng=j_rng)
    got = build_pairs_self_chain(t_docs, test=test_mode, rng=t_rng)
    want = j_build(j_docs, test=test_mode, rng=j_rng)
    assert [dataclasses.asdict(e) for e in got.examples] == \
        [dataclasses.asdict(e) for e in want.examples]
    assert got.docs_pair_size == want.docs_pair_size
    assert got.num_unpred_emotions == want.num_unpred_emotions == 0
    assert t_rng.random() == j_rng.random()
    kept = {e.doc_index for e in got.examples}
    if test_mode:  # only the self-chain documents, each kept once
        assert kept == {int(i) - 1 for i in self_chain_doc_ids(t_docs)}
    else:
        assert kept == set(range(len(t_docs)))
