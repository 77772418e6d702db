"""The unsupervised stack's data layer in the port (masking additions,
``PackedCorpus``, ``TextOnlyDataset``, tags, ``UnsupervisedPretrainDataset``,
the Batcher's ``batch_transform`` hook, ``HybridBatcher``,
``UnsupVQADataset``, ``AnswerTable``) against the JAX package, on the CPU:
every example, batch and deck bit for bit, from the same seeds."""

import numpy as np
import pytest

from visualbert_tpu.data import masking as jax_masking
from visualbert_tpu.data import tags as jax_tags
from visualbert_tpu.data.answer_table import AnswerTable as JaxAnswerTable
from visualbert_tpu.data.answer_table import normalize_answer as jax_normalize_answer
from visualbert_tpu.data.answer_table import remap_answer_head as jax_remap_answer_head
from visualbert_tpu.data.datasets import unsup_pretrain as jax_up
from visualbert_tpu.data.datasets import unsup_vqa as jax_uv
from visualbert_tpu.data.features import normalize_boxes as jax_normalize_boxes
from visualbert_tpu.data.hybrid import HybridBatcher as JaxHybridBatcher
from visualbert_tpu.data.pipeline import Batcher as JaxBatcher
from visualbert_tpu.data.symbolic import SymbolicVocab as JaxSymbolicVocab
from visualbert_tpu.data.symbolic import initialize_symbolic_embedding as jax_init_symbolic
from visualbert_tpu.data.text_corpus import PackedCorpus as JaxPackedCorpus
from visualbert_tpu.data.text_corpus import TextOnlyDataset as JaxTextOnlyDataset
from visualbert_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from visualbert_torch.data import masking, tags
from visualbert_torch.data.answer_table import AnswerTable, normalize_answer, remap_answer_head
from visualbert_torch.data.datasets import unsup_pretrain as up
from visualbert_torch.data.datasets import unsup_vqa as uv
from visualbert_torch.data.features import normalize_boxes
from visualbert_torch.data.hybrid import HybridBatcher
from visualbert_torch.data.pipeline import Batcher
from visualbert_torch.data.symbolic import SymbolicVocab, initialize_symbolic_embedding
from visualbert_torch.data.text_corpus import PackedCorpus, TextOnlyDataset
from visualbert_torch.data.tokenization import BertTokenizer

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + [f"w{i}" for i in range(40)] + ["##2", "##3", "##s"]
OBJECTS, ATTRIBUTES = [f"obj{i}" for i in range(20)], [f"attr{i}" for i in range(8)]


def tokenizers():
    vocab = {w: i for i, w in enumerate(VOCAB)}
    return BertTokenizer(vocab), JaxTokenizer(vocab)


def vocabs():
    return SymbolicVocab(OBJECTS, ATTRIBUTES), JaxSymbolicVocab(OBJECTS, ATTRIBUTES)


def assert_same(a, b, what=""):
    """Equal dicts of arrays: keys, dtypes, shapes and bytes."""
    assert set(a) == set(b), what
    for k in a:
        if k.startswith("_"):
            assert a[k] == b[k], (what, k)
            continue
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k, x.dtype, y.dtype, x.shape, y.shape)
        assert x.tobytes() == y.tobytes(), (what, k)


def assert_same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert_same(a, b, f"batch {i}")


PASSAGES = [["w1 w2s w3", "w4 w5"], ["w6 w7 w8 w9"], [f"w{i}" for i in range(10, 30)],
            ["w2 w3s w4s w5", "w6", "w7 w8"], ["w30 w31 w32 w33 w34 w35 w36 w37 w38 w39 w1 w2 w3"]]


def test_tokenizer_additions_match_jax():
    ours, theirs = tokenizers()
    for text in ("w1 w2s w3", "w12s w3 zebra", ""):
        assert ours.encode(text) == theirs.encode(text)
    ids = list(range(len(VOCAB)))
    assert ours.convert_ids_to_tokens(ids) == theirs.convert_ids_to_tokens(ids)
    assert ours.ids_to_tokens == theirs.ids_to_tokens
    for name in ("cls_id", "sep_id", "mask_id", "pad_id"):
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("seed", range(4))
def test_masking_additions_match_jax(seed):
    ours, theirs = tokenizers()
    words = ["w1", "w2s", "w33", "w3s", "zebra", "w4"] * 3
    pieces = ["w1", "w2", "##2", "##3", "w4", "##s", "w5"] * 4
    assert masking.random_word_wwm(words, ours, np.random.default_rng(seed), 0.4) == \
        jax_masking.random_word_wwm(words, theirs, np.random.default_rng(seed), 0.4)
    for group in (True, False):
        assert masking.random_word_wwm_pieces(pieces, ours, np.random.default_rng(seed), 0.4, group) == \
            jax_masking.random_word_wwm_pieces(pieces, theirs, np.random.default_rng(seed), 0.4, group)
    assert masking.truncate_front(list(words), 5 + seed) == jax_masking.truncate_front(list(words), 5 + seed)
    feats = np.random.default_rng(seed + 10).normal(size=(12, 8)).astype(np.float32)
    pool = np.random.default_rng(seed + 20).normal(size=(5, 8)).astype(np.float32)
    for kw in (dict(in_batch_mark=True), dict(in_batch_mark=False), dict(pool=pool)):
        f1, m1 = masking.random_mask_features(feats, np.random.default_rng(seed), 0.5, **kw)
        f2, m2 = jax_masking.random_mask_features(feats, np.random.default_rng(seed), 0.5, **kw)
        assert f1.tobytes() == f2.tobytes() and m1.tobytes() == m2.tobytes(), kw


def marked_batch(seed, B=5, N=6):
    rng = np.random.default_rng(seed)
    fm = rng.choice(np.array([0.0, 1.0, 2.0], np.float32), size=(B, N), p=[0.5, 0.2, 0.3])
    return {"visual_feats": rng.normal(size=(B, N, 4)).astype(np.float32), "feat_mask": fm,
            "feat_target": rng.normal(size=(B, N, 4)).astype(np.float32)}


@pytest.mark.parametrize("B,N", [(5, 6), (1, 6), (4, 1)], ids=["batch", "one_example", "one_region"])
def test_in_batch_random_replace_matches_jax(B, N):
    a, b = marked_batch(3, B, N), marked_batch(3, B, N)
    assert (a["feat_mask"] == 2.0).any()
    out = masking.in_batch_random_replace(a, np.random.default_rng(9))
    assert_same(out, jax_masking.in_batch_random_replace(b, np.random.default_rng(9)))
    assert not (out["feat_mask"] == 2.0).any()
    assert masking.in_batch_random_replace({"input_ids": np.zeros(3)}, None)["input_ids"].shape == (3,)


def test_packed_corpus_round_trip_matches_jax(tmp_path):
    ours_t, theirs_t = tokenizers()
    ours, theirs = PackedCorpus.build(PASSAGES, ours_t), JaxPackedCorpus.build(PASSAGES, theirs_t)
    for name in ("tokens", "sentence_offsets", "passage_offsets"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    ours.save(str(tmp_path / "ours.npz"))
    theirs.save(str(tmp_path / "theirs.npz"))
    # each package reads the other's file
    for loaded, want in ((PackedCorpus.load(str(tmp_path / "theirs.npz")), ours),
                         (JaxPackedCorpus.load(str(tmp_path / "ours.npz")), theirs)):
        assert loaded.n_passages == want.n_passages == 5 and loaded.n_sentences == want.n_sentences
        assert np.array_equal(loaded.tokens, want.tokens)
    for p in range(ours.n_passages):
        assert ours.passage_n_sentences(p) == theirs.passage_n_sentences(p)
        for start in (0, 1, 5, 1 << 29):
            for budget in (1, 3, 40):
                for stop in (None, 0, 1, 2):
                    a, n_a = ours.piece_with_span(p, start, budget, stop_sent=stop)
                    b, n_b = theirs.piece_with_span(p, start, budget, stop_sent=stop)
                    assert a.tobytes() == b.tobytes() and n_a == n_b
        assert ours.piece(p, 1, 4).tobytes() == theirs.piece(p, 1, 4).tobytes()


@pytest.mark.parametrize("matched,group", [(False, True), (False, False), (True, True), (True, False)],
                         ids=["mlm_wwm", "mlm_pieces", "matched_wwm", "matched_pieces"])
def test_text_only_dataset_matches_jax(matched, group):
    """Item by item over every passage and many seeds; the matched mode
    reaches the swap, the continuation, its wrap and the fallback."""
    ours_t, theirs_t = tokenizers()
    kw = dict(max_seq_length=16, matched_objective=matched, group_continuations=group, mask_prob=0.3)
    ours = TextOnlyDataset(PackedCorpus.build(PASSAGES, ours_t), ours_t, **kw)
    theirs = JaxTextOnlyDataset(JaxPackedCorpus.build(PASSAGES, theirs_t), theirs_t, **kw)
    labels = set()
    for seed in range(40):
        for i in range(len(ours)):
            a = ours[(i, np.random.default_rng((seed, i)))]
            assert_same(a, theirs[(i, np.random.default_rng((seed, i)))], f"{seed} {i}")
            labels.add(int(a.get("matched_label", -1)))
    assert labels == ({0, 1} if matched else {-1})


def test_matched_single_passage_duplicate_matches_jax():
    """One passage that a consumes whole: the unavoidable duplicate branch."""
    ours_t, theirs_t = tokenizers()
    kw = dict(max_seq_length=40, matched_objective=True, mask_prob=0.0)
    ours = TextOnlyDataset(PackedCorpus.build([["w1 w2", "w3"]], ours_t), ours_t, **kw)
    theirs = JaxTextOnlyDataset(JaxPackedCorpus.build([["w1 w2", "w3"]], theirs_t), theirs_t, **kw)
    for seed in range(10):
        assert_same(ours[(0, np.random.default_rng(seed))], theirs[(0, np.random.default_rng(seed))])


@pytest.mark.parametrize("seed", range(3))
def test_tags_match_jax(seed):
    ours_v, theirs_v = vocabs()
    rng = np.random.default_rng(100 + seed)
    obj, attr = rng.integers(0, 20, 12), rng.integers(0, 8, 12)
    boxes = rng.random((12, 4)).astype(np.float64)
    fm = (rng.random(12) < 0.4).astype(np.float32)
    for ratio in (0.0, 0.5):
        t1, b1 = tags.build_tags(obj, attr, boxes, ours_v, np.random.default_rng(seed), ratio)
        t2, b2 = jax_tags.build_tags(obj, attr, boxes, theirs_v, np.random.default_rng(seed), ratio)
        assert t1.tobytes() == t2.tobytes() and b1.tobytes() == b2.tobytes() and b1.dtype == np.float32
    for kw in (dict(), dict(feature_mask=fm, tag_joint_mask_ratio=0.5),
               dict(feature_mask=fm, tag_joint_mask_ratio=1.0)):
        c1, o1 = tags.mask_tags(t1, ours_v, np.random.default_rng(seed), 0.3, **kw)
        c2, o2 = jax_tags.mask_tags(t2, theirs_v, np.random.default_rng(seed), 0.3, **kw)
        assert c1.tobytes() == c2.tobytes() and o1.tobytes() == o2.tobytes(), kw
    assert (o1[fm > 0] == t1[fm > 0]).all()  # full coupling: every masked region's tag is predicted


def test_symbolic_vocab_matches_jax(tmp_path):
    ours, theirs = vocabs()
    ours_t, theirs_t = tokenizers()
    for name in ("n_obj", "n_attr", "cls_id", "sep_id", "mask_id", "size"):
        assert getattr(ours, name) == getattr(theirs, name)
    assert [ours.symbolic_to_word(i) for i in range(ours.size)] == [theirs.symbolic_to_word(i) for i in
                                                                     range(theirs.size)]
    subs = ours.subword_lists(ours_t)
    assert subs == theirs.subword_lists(theirs_t)
    table = np.random.default_rng(0).normal(size=(len(VOCAB), 8))
    assert initialize_symbolic_embedding(table, subs).tobytes() == jax_init_symbolic(table, subs).tobytes()
    (tmp_path / "o.txt").write_text("cat,kitty\ndog\n\nw3s\n")
    (tmp_path / "a.txt").write_text("red\nbig,large\n")
    a = SymbolicVocab.from_files(str(tmp_path / "o.txt"), str(tmp_path / "a.txt"))
    b = JaxSymbolicVocab.from_files(str(tmp_path / "o.txt"), str(tmp_path / "a.txt"))
    assert a.objects == b.objects == ["cat", "dog", "w3s"] and a.attributes == b.attributes
    assert a.subword_lists(ours_t) == b.subword_lists(theirs_t)


def test_normalize_boxes_matches_jax():
    boxes = np.random.default_rng(1).uniform(-2, 14, size=(7, 4)).astype(np.float32)
    assert normalize_boxes(boxes, 10.0, 12.0).tobytes() == jax_normalize_boxes(boxes, 10.0, 12.0).tobytes()


def pretrain_datasets(n=24, **kw):
    ours_t, theirs_t = tokenizers()
    ours_v, theirs_v = vocabs()
    ann, feats = up.make_synthetic(n, ours_t, ours_v, feat_dim=8, answers=3)
    ann_j, feats_j = jax_up.make_synthetic(n, theirs_t, theirs_v, feat_dim=8, answers=3)
    assert ann == ann_j
    for a in ann:
        assert_same(feats.get(a["image_id"]), feats_j.get(a["image_id"]))
    # integer answers on some items (a string answer stays ignored)
    for i, item in enumerate(ann):
        if i % 3:
            item["ans"] = ann_j[i]["ans"] = i % 5
    if n > 3:
        del ann[3]["sentence"], ann_j[3]["sentence"]  # an image without a sentence
    kw = dict(dict(max_seq_length=12, n_regions=6, matched_prob=0.5), **kw)
    return (up.UnsupervisedPretrainDataset(ann, feats, ours_t, ours_v, **kw),
            jax_up.UnsupervisedPretrainDataset(ann_j, feats_j, theirs_t, theirs_v, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(image_only=True), dict(inbatch_random=False, matched_prob=0.9),
                                dict(text_available=False, insert_attr_ratio=0.5)],
                         ids=["vl", "image_only", "matched_swap", "no_text"])
def test_unsup_pretrain_examples_match_jax(kw):
    ours, theirs = pretrain_datasets(**kw)
    keys = set()
    for seed in range(3):
        for i in range(len(ours)):
            a = ours[(i, np.random.default_rng((seed, i)))]
            assert_same(a, theirs[(i, np.random.default_rng((seed, i)))], f"{seed} {i}")
            keys.add("input_ids" in a)
            if "matched_label" in a and kw.get("matched_prob") == 0.9:
                keys.add(("matched", int(a["matched_label"])))
    want_text = not (kw.get("image_only") or kw.get("text_available") is False)
    assert keys >= {want_text}
    if kw.get("matched_prob") == 0.9:
        assert {("matched", 0), ("matched", 1)} <= keys


def test_unsup_pretrain_batches_with_inbatch_random_match_jax():
    """Whole batches through both Batchers (threads, a padded eval tail):
    the batch-level hook resolves every 2.0 mark with the same draws."""
    ours, theirs = pretrain_datasets(n=23, feature_mask_prob=0.6)
    ours.annotations[3]["sentence"] = theirs.annotations[3]["sentence"] = "w1 w2"  # one key set a batch
    assert ours.batch_transform is masking.in_batch_random_replace
    marks = sum(int((ours[(i, np.random.default_rng((3, 0, i)))]["feat_mask"] == 2.0).sum()) for i in range(23))
    assert marks > 5
    kws = [dict(seed=3, num_workers=2), dict(shuffle=False, drop_last=False, pad_final=True)]
    for kw in kws:
        b1, b2 = Batcher(ours, 5, **kw), JaxBatcher(theirs, 5, **kw)
        try:
            assert b1.num_batches() == b2.num_batches() == (4 if "seed" in kw else 5)
            for epoch in (0, 1):
                got = list(b1.epoch(epoch))
                assert_same_batches(got, b2.epoch(epoch))
                assert all(not (g["feat_mask"] == 2.0).any() for g in got)
        finally:
            b1.close()
            b2.close()
    # without the hook the marks stay in the batch
    ours.inbatch_random = theirs.inbatch_random = False
    assert ours.batch_transform is None


def test_hybrid_epoch_over_three_sources_matches_jax(tmp_path):
    """V&L, image-only (ratio 0.5) and text-only (ratio 2.0, so it wraps)
    sources: each source's batches and the deck order, two epochs."""
    ours_t, theirs_t = tokenizers()
    vl, vl_j = pretrain_datasets(n=24)
    for ds in (vl, vl_j):
        for item in ds.annotations:
            item.setdefault("sentence", "w1 w2")
    img, img_j = pretrain_datasets(n=24, image_only=True)
    txt = TextOnlyDataset(PackedCorpus.build(PASSAGES * 4, ours_t), ours_t, max_seq_length=12)
    txt_j = JaxTextOnlyDataset(JaxPackedCorpus.build(PASSAGES * 4, theirs_t), theirs_t, max_seq_length=12)
    ratios = [1.0, 0.5, 2.0]
    ours = HybridBatcher([Batcher(vl, 4, seed=0), Batcher(img, 4, seed=1), Batcher(txt, 4, seed=0)], ratios, seed=5)
    theirs = JaxHybridBatcher([JaxBatcher(vl_j, 4, seed=0), JaxBatcher(img_j, 4, seed=1),
                               JaxBatcher(txt_j, 4, seed=0)], ratios, seed=5)
    assert ours.num_batches() == theirs.num_batches() == 6 + 3 + 10
    for epoch in (0, 1):
        got = list(ours.epoch(epoch))
        assert_same_batches(got, theirs.epoch(epoch))
        kinds = ["vl" if "input_ids" in b and "visual_feats" in b else "img" if "visual_feats" in b else "txt"
                 for b in got]
        deck = ours.deck(epoch)
        assert kinds == [("vl", "img", "txt")[i] for i in deck]
        assert [kinds.count(k) for k in ("vl", "img", "txt")] == [6, 3, 10]
    ours.close()


@pytest.mark.parametrize("ratio", [0.0, 0.4])
def test_unsup_vqa_examples_match_jax(ratio):
    ours_t, theirs_t = tokenizers()
    ours_v, theirs_v = vocabs()
    ann, feats, answers = uv.make_synthetic(20, ours_t, ours_v, n_answers=5, feat_dim=8)
    ann_j, feats_j, answers_j = jax_uv.make_synthetic(20, theirs_t, theirs_v, n_answers=5, feat_dim=8)
    assert ann == ann_j and answers == answers_j
    ann[2]["label"] = ann_j[2]["label"] = {"a1": 0.3, "nope": 1.0, "a4": 0.9}
    del ann[5]["question_id"], ann_j[5]["question_id"]
    ann[6]["sent"] = ann_j[6]["sent"] = " ".join(["w3s"] * 20)  # cut at max_seq_length
    kw = dict(max_seq_length=10, n_regions=6, insert_attr_ratio=ratio)
    ours = uv.UnsupVQADataset(ann, feats, ours_t, ours_v, answers, **kw)
    theirs = jax_uv.UnsupVQADataset(ann_j, feats_j, theirs_t, theirs_v, answers_j, **kw)
    for i in range(len(ours)):
        assert_same(ours[(i, np.random.default_rng(i))], theirs[(i, np.random.default_rng(i))], str(i))
        assert_same(ours[i], theirs[i], str(i))  # an index alone
    tail = dict(shuffle=False, drop_last=False, pad_final=True)
    assert_same_batches(Batcher(ours, 8, **tail).epoch(0), JaxBatcher(theirs, 8, **tail).epoch(0))


def test_answer_table_matches_jax(tmp_path):
    answers = ["Yes", "the man", "Two.", "grey", "an apple", "a woman", "dog", ""]
    for a in answers + ["THE WOMAN.", "ten", "A Cat"]:
        assert normalize_answer(a) == jax_normalize_answer(a)
    ours, theirs = AnswerTable(answers), JaxAnswerTable(answers)
    assert ours.answers == theirs.answers and ours.ans2id == theirs.ans2id and len(ours) == len(theirs)
    (tmp_path / "t.json").write_text('["cat", "The dog", "1"]')
    assert AnswerTable.from_json(str(tmp_path / "t.json")).answers == \
        JaxAnswerTable.from_json(str(tmp_path / "t.json")).answers
    for a in ("man", "A man", "2", "zebra", "Grey"):
        assert ours.ans_to_id(a) == theirs.ans_to_id(a) and ours.used(a) == theirs.used(a)
    assert ours.id_to_ans(3) == theirs.id_to_ans(3) == "gray"
    src, dst = AnswerTable(["yes", "no", "cat", "dog"]), AnswerTable(["dog", "bird", "yes"])
    rng = np.random.default_rng(0)
    k, b = rng.normal(size=(2, 4)), rng.normal(size=4)
    fk, fb = rng.normal(size=(2, 3)), rng.normal(size=3)
    for zero in (True, False):
        got = remap_answer_head(k, b, src, dst, fk, fb, zero_unmatched=zero)
        want = jax_remap_answer_head(k, b, JaxAnswerTable(src.answers), JaxAnswerTable(dst.answers), fk, fb,
                                     zero_unmatched=zero)
        assert got["n_copied"] == want["n_copied"] == 2
        assert got["kernel"].tobytes() == want["kernel"].tobytes() and got["bias"].tobytes() == want["bias"].tobytes()
