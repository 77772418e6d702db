"""The port's data layer (visualbert_torch/data, a copy of the JAX package's
for COCO pretraining) against the JAX package's: the same strings tokenize
to the same pieces and ids, and ``CocoCaptionsDataset`` + ``Batcher`` yield
byte-identical batches (same keys, dtypes, shapes and bytes) over two epochs
at 0 and 4 worker threads."""

import numpy as np
import pytest

from visualbert_tpu.data import tokenization as jax_tok
from visualbert_tpu.data.datasets import coco as jax_coco
from visualbert_tpu.data.features import NpyFolderFeatures as JaxNpyFolderFeatures
from visualbert_tpu.data.pipeline import Batcher as JaxBatcher
from visualbert_torch.data import tokenization as tok
from visualbert_torch.data.datasets import coco
from visualbert_torch.data.features import NpyFolderFeatures
from visualbert_torch.data.pipeline import Batcher, default_collate

WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "a", "cat", "dog", "sat", "on", "mat", "##s",
         "run", "##ning", "play", "##ing", "caf", "##e", "au", "lait", "man", "riding", "horse", "beach",
         "two", "people", "red", "bus", "street", "!", ",", ".", "?", "'", "-"]
CAPTIONS = [
    "The cats sat on the mat!", "A dog running, playing?", "Café au lait.", "A man riding a horse on the beach",
    "Two people play on a red bus", "the street's cat - sat", "日本 dog", "\tweird\x00 control​ chars",
    "a " + "x" * 120, "DOGS running on the STREET",
]


def vocab():
    return {w: i for i, w in enumerate(WORDS)}


def test_tokenizer_matches_jax():
    ours, theirs = tok.BertTokenizer(vocab()), jax_tok.BertTokenizer(vocab())
    for text in CAPTIONS:
        pieces = ours.tokenize(text)
        assert pieces == theirs.tokenize(text), text
        assert ours.convert_tokens_to_ids(pieces) == theirs.encode(text), text
    assert "##e" in ours.tokenize("Café")  # accents stripped, then WordPiece
    assert ours.tokenize("a " + "x" * 120) == ["a", "[UNK]"]  # over-long word
    assert ours.tokenize("[MASK] Cat") == ["[MASK]", "cat"]  # special tokens are not split


def test_vocab_file_round_trip(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(WORDS) + "\n")
    assert tok.load_vocab(str(path)) == jax_tok.load_vocab(str(path)) == vocab()


def coco_pair(tmp_path, two_sentence):
    """The same annotations and .npy feature folder read by both packages."""
    rng = np.random.RandomState(0)
    ann = []
    for i in range(10):
        # ragged region counts: some pad to max_regions, one is cut to it
        np.save(tmp_path / f"img{i}.npy", rng.randn(3 + 2 * i, 8).astype(np.float32))
        ann.append({"image_id": f"img{i}", "captions": [CAPTIONS[(i + k) % len(CAPTIONS)] for k in range(1 + i % 3)]})
    kw = dict(max_seq_length=16, max_regions=12, two_sentence=two_sentence)
    ours = coco.CocoCaptionsDataset(ann, NpyFolderFeatures(str(tmp_path)), tok.BertTokenizer(vocab()), **kw)
    theirs = jax_coco.CocoCaptionsDataset(ann, JaxNpyFolderFeatures(str(tmp_path)), jax_tok.BertTokenizer(vocab()),
                                          **kw)
    return ours, theirs


def assert_same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in a:
            if k.startswith("_"):
                assert a[k] == b[k], k
                continue
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("two_sentence", [True, False])
@pytest.mark.parametrize("num_workers", [0, 4])
def test_coco_batches_are_byte_identical_to_jax(tmp_path, two_sentence, num_workers):
    ours, theirs = coco_pair(tmp_path, two_sentence)
    tail = dict(shuffle=False, drop_last=False, pad_final=True, num_workers=num_workers)
    batchers = [Batcher(ours, 4, seed=3, num_workers=num_workers), JaxBatcher(theirs, 4, seed=3, num_workers=num_workers),
                Batcher(ours, 4, **tail), JaxBatcher(theirs, 4, **tail)]
    try:
        for epoch in (0, 1):
            assert_same_batches(batchers[0].epoch(epoch), batchers[1].epoch(epoch))
        # pad_final: the repeated tail rows weigh 0
        assert_same_batches(batchers[2].epoch(0), batchers[3].epoch(0))
        last = list(batchers[2].epoch(0))[-1]
        assert last["_real_count"] == 2.0 and last["example_weight"].tolist() == [1.0, 1.0, 0.0, 0.0]
    finally:
        for b in batchers:
            b.close()


def test_batch_is_the_default_collate_of_its_samples(tmp_path):
    """The Batcher writes each sample into the batch arrays in place; the
    result is what stacking the samples gives."""
    ours, _ = coco_pair(tmp_path, True)
    batch = next(Batcher(ours, 4, shuffle=False, seed=3).epoch(5))
    samples = [ours[(i, np.random.default_rng((3, 5, i)))] for i in range(4)]
    assert_same_batches([batch], [default_collate(samples)])


def test_synthetic_coco_matches_jax():
    t_ours, t_theirs = tok.BertTokenizer(vocab()), jax_tok.BertTokenizer(vocab())
    ann, feats = coco.make_synthetic(12, t_ours, feat_dim=16)
    ann_j, feats_j = jax_coco.make_synthetic(12, t_theirs, feat_dim=16)
    assert ann == ann_j
    for a in ann:
        assert feats.get(a["image_id"])["features"].tobytes() == feats_j.get(a["image_id"])["features"].tobytes()
    ours = coco.CocoCaptionsDataset(ann, feats, t_ours, max_seq_length=20, max_regions=10)
    theirs = jax_coco.CocoCaptionsDataset(ann_j, feats_j, t_theirs, max_seq_length=20, max_regions=10)
    assert_same_batches(Batcher(ours, 6, seed=1).epoch(0), JaxBatcher(theirs, 6, seed=1).epoch(0))
