"""The data layer's host pieces in the port against the JAX package, on the
CPU: ``H5Features`` and ``ConcatFeatures`` (data/features.py), the native
WordPiece tokenizer (data/fast_tokenizer.py), the Batcher's process workers
(data/pipeline.py) and the data tools (tools/prepare_data.py,
tools/convert_tsv_to_h5.py)."""

import base64
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from visualbert_tpu.data import features as jax_features
from visualbert_tpu.data.fast_tokenizer import FastBertTokenizer as JaxFastTokenizer
from visualbert_tpu.tools import convert_tsv_to_h5 as jax_tsv
from visualbert_tpu.tools import prepare_data as jax_prep
from visualbert_torch.data import fast_tokenizer
from visualbert_torch.data.datasets import coco, unsup_pretrain, vqa
from visualbert_torch.data.fast_tokenizer import FastBertTokenizer
from visualbert_torch.data.features import ChunkFeatures, ConcatFeatures, H5Features
from visualbert_torch.data.pipeline import Batcher
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.tools import convert_tsv_to_h5, prepare_data
from test_torch_real_data import SYM, write_h5
from test_torch_vqa import WORDS, assert_same_batches

h5py = pytest.importorskip("h5py")


# ---- HDF5 features ----


def butd_chunk(n=5, boxes=4, dim=6, seed=0, prefix=""):
    rng = np.random.default_rng(seed)
    return {f"{prefix}{i}": {"features": rng.normal(size=(boxes, dim)).astype(np.float32),
                             "boxes": rng.random((boxes, 4)).astype(np.float32) * 50,
                             "objects_id": rng.integers(0, 30, boxes), "objects_conf": rng.random(boxes).astype(np.float32),
                             "attrs_id": rng.integers(0, 8, boxes), "attrs_conf": rng.random(boxes).astype(np.float32),
                             "img_h": np.int64(48), "img_w": np.int64(64)} for i in range(n)}


def assert_same_rows(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("sidecar", ["json", "txt"])
def test_h5_features_read_as_jax_reads_them(tmp_path, sidecar):
    chunk = butd_chunk()
    path = write_h5(chunk, tmp_path / "f.h5", sidecar)
    ours, theirs = H5Features(path), jax_features.H5Features(path)
    assert ours.index == theirs.index
    for i in chunk:
        assert i in ours and i in theirs
        row = ours.get(i)
        assert_same_rows(row, theirs.get(i))
        assert row["features"].dtype == np.float32 and set(row) == set(chunk[i])
        np.testing.assert_array_equal(row["boxes"], chunk[i]["boxes"])
    assert "x" not in ours
    # given ids override the sidecar; an optional key may be absent
    with h5py.File(tmp_path / "g.h5", "w") as f:
        f.create_dataset("features", data=np.ones((2, 3, 4), np.float32))
    only = H5Features(str(tmp_path / "g.h5"), ids=["a", "b"])
    assert set(only.get("b")) == {"features"} and only.get("b")["features"].shape == (3, 4)
    with pytest.raises(FileNotFoundError, match="sidecar"):
        H5Features(str(tmp_path / "g.h5"))


def test_h5_features_open_a_handle_a_thread(tmp_path):
    chunk = butd_chunk(n=12)
    store = H5Features(write_h5(chunk, tmp_path / "f.h5"))
    with ThreadPoolExecutor(4) as pool:
        rows = list(pool.map(lambda i: store.get(str(i % 12)), range(48)))
    for j, row in enumerate(rows):
        np.testing.assert_array_equal(row["features"], chunk[str(j % 12)]["features"])


def test_concat_features_first_store_wins_as_jax(tmp_path):
    a = butd_chunk(n=3, seed=1)
    b = butd_chunk(n=5, seed=2)  # ids 0-4: 0-2 also in a
    h5 = write_h5(b, tmp_path / "b.h5")
    ours = ConcatFeatures([ChunkFeatures(a), H5Features(h5)])
    theirs = jax_features.ConcatFeatures([jax_features.ChunkFeatures(a), jax_features.H5Features(h5)])
    for i in ("0", "2", "3", "4"):
        assert_same_rows(ours.get(i), theirs.get(i))
    np.testing.assert_array_equal(ours.get("1")["features"], a["1"]["features"])
    np.testing.assert_array_equal(ours.get("4")["features"], b["4"]["features"])
    assert "4" in ours and "9" not in ours
    with pytest.raises(KeyError):
        ours.get("9")


def test_missing_h5py_raises_naming_it(tmp_path, monkeypatch):
    path = write_h5(butd_chunk(n=2), tmp_path / "f.h5")
    store = H5Features(path)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        store.get("0")


# ---- the native tokenizer ----

TEXTS = [
    "The quick brown fox jumps over the lazy dog!",
    "unwanted running",
    "  weird   whitespace\tand\nnewlines ",
    "UNWANTED, RUNNING.",
    "120 30",
    "dog's",
    "zzz unknownword",
    "",
    "!!!",
    "a" * 150,
    "café naïve",
    "中国 hello",
    "Ünwanted résumé, running!",
]
VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] the quick brown fox jump ##s ##ed over a lazy dog ! , . un ##want run "
         "##ning 1 2 3 ##0 hello world cafe ' s naive").split()


@pytest.fixture(scope="module")
def tokenizers():
    vocab = {w: i for i, w in enumerate(VOCAB)}
    return FastBertTokenizer(vocab), BertTokenizer(vocab), JaxFastTokenizer(vocab)


def test_native_tokenizer_is_byte_exact_with_the_python_one(tokenizers):
    fast, plain, theirs = tokenizers
    assert fast.native_available
    for text in TEXTS:
        assert fast.encode(text) == plain.encode(text) == theirs.encode(text), text
        assert fast.tokenize(text) == plain.tokenize(text), text


@pytest.mark.parametrize("texts", [TEXTS[:9], TEXTS], ids=["ascii", "with_non_ascii"])
def test_encode_batch_equals_encode(tokenizers, texts):
    fast, plain, theirs = tokenizers
    out, lens = fast.encode_batch(texts, max_len=12)
    want, want_lens = theirs.encode_batch(texts, max_len=12)
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(lens, want_lens)
    for i, t in enumerate(texts):
        assert list(out[i, : lens[i]]) == plain.encode(t)[:12] and not out[i, lens[i]:].any()


def test_native_library_is_built_into_the_ports_build_folder(tokenizers):
    path = fast_tokenizer.library_path()
    assert path.exists() and path.parent.parent == fast_tokenizer.BUILD_ROOT
    assert fast_tokenizer.BUILD_ROOT.name == "_build" and fast_tokenizer.BUILD_ROOT.parent.name == "visualbert_torch"
    assert fast_tokenizer.SOURCE.parent.name == "csrc"


def test_a_failed_build_raises_with_the_compilers_log(tmp_path, monkeypatch):
    broken = tmp_path / "wordpiece.cpp"
    broken.write_text("int main( { this is not C++\n")
    monkeypatch.setattr(fast_tokenizer, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed(.|\n)*error"):
        fast_tokenizer.build(tmp_path / "out" / "libwordpiece.so")
    assert not (tmp_path / "out" / "libwordpiece.so").exists()


def test_sparse_ids_take_the_python_path():
    vocab = {w: 2 * i for i, w in enumerate(VOCAB)}
    fast = FastBertTokenizer(vocab)
    assert not fast.native_available
    assert fast.encode("the lazy dog") == BertTokenizer(vocab).encode("the lazy dog")


# ---- process workers ----


def coco_set():
    tok = BertTokenizer({w: i for i, w in enumerate(WORDS)})
    ann, feats = coco.make_synthetic(29, tok, feat_dim=16)
    return coco.CocoCaptionsDataset(ann, feats, tok, max_seq_length=16, max_regions=10)


def unsup_set():
    """A set with a batch transform (the in-batch random feature swap)."""
    tok = BertTokenizer({w: i for i, w in enumerate(WORDS)})
    ann, feats = unsup_pretrain.make_synthetic(21, tok, SYM, n_regions=6, feat_dim=16)
    return unsup_pretrain.UnsupervisedPretrainDataset(ann, feats, tok, SYM, max_seq_length=12, n_regions=6,
                                                      inbatch_random=True)


def vqa_h5_set(tmp_path):
    tok = BertTokenizer({w: i for i, w in enumerate(WORDS)})
    ann, feats, vocab = vqa.make_synthetic(19, tok, feat_dim=16)
    return vqa.VQADataset(ann, H5Features(write_h5(feats.chunk, tmp_path / "f.h5")), tok, vocab, max_seq_length=14,
                          max_regions=10)


@pytest.mark.parametrize("make,kw", [
    (lambda _: coco_set(), dict(seed=3)),
    (lambda _: coco_set(), dict(seed=3, shuffle=False, drop_last=False, pad_final=True)),
    (lambda _: unsup_set(), dict(seed=1, drop_last=False)),
    (vqa_h5_set, dict(seed=2, drop_last=False, pad_final=True)),
], ids=["coco", "coco_pad_final", "unsup_batch_transform", "vqa_hdf5"])
def test_process_batches_equal_thread_and_sequential_batches(tmp_path, make, kw):
    """Bit for bit, every batch of two epochs, each process-mode batch held
    until the end (a slot still referenced is never reused)."""
    ds = make(tmp_path)
    seq = Batcher(ds, 8, **kw)
    thr = Batcher(ds, 8, num_workers=3, **kw)
    proc = Batcher(ds, 8, num_workers=3, worker_mode="process", **kw)
    try:
        for epoch in (0, 1):
            held = list(proc.epoch(epoch))
            assert_same_batches(seq.epoch(epoch), held)
            assert_same_batches(thr.epoch(epoch), held)
    finally:
        for b in (thr, proc):
            b.close()


class Broken:
    def __len__(self):
        return 16

    def __getitem__(self, args):
        i, rng = args
        if i == 7:
            raise ValueError("boom at 7")
        return {"x": np.full(3, i, np.float32)}


def test_process_workers_propagate_errors_and_close_is_terminal():
    proc = Batcher(Broken(), 8, seed=0, shuffle=False, num_workers=2, worker_mode="process")
    try:
        with pytest.raises(RuntimeError, match="boom at 7"):
            list(proc.epoch(0))
    finally:
        proc.close()
    ok = Batcher(coco_set(), 8, num_workers=2, worker_mode="process")
    it = ok.epoch(0)
    next(it)
    ok.close()
    with pytest.raises(RuntimeError, match="closed"):
        next(it)
    with pytest.raises(ValueError, match="worker_mode"):
        Batcher(Broken(), 8, worker_mode="fork")


# ---- data tools ----


def tool_inputs(tmp_path):
    """The official-format inputs of tests/test_prepare_data.py."""
    (tmp_path / "captions.json").write_text(json.dumps({"annotations": [
        {"image_id": 7, "caption": "a dog"}, {"image_id": 7, "caption": "a brown dog"},
        {"image_id": 9, "caption": "a cat"}]}))
    (tmp_path / "questions.json").write_text(json.dumps({"questions": [
        {"question": "What color is the dog?", "image_id": 7, "question_id": 70},
        {"question": "Is it day?", "image_id": 9, "question_id": 71}]}))
    (tmp_path / "annotations.json").write_text(json.dumps({"annotations": [
        {"question_id": 70, "answers": [{"answer": "brown"}] * 10}]}))
    (tmp_path / "dev.jsonl").write_text(
        json.dumps({"identifier": "dev-850-0-0", "sentence": "two dogs", "label": "True"}) + "\n"
        + json.dumps({"identifier": "dev-850-1-0", "sentence": "one cat", "label": "False"}) + "\n")
    (tmp_path / "vcr.jsonl").write_text(json.dumps({
        "img_id": "val-42", "question": ["why", "is", [0], "smiling", "?"],
        "answer_choices": [["because", [1]], ["happy"], ["sad"], ["tired"]], "answer_label": 0,
        "rationale_choices": [["r1"], ["r2"], ["r3"], ["r4"]], "rationale_label": 2,
        "objects": ["person", "dog"]}) + "\n")
    (tmp_path / "cc.tsv").write_text("a dog on a beach\thttp://x/0.jpg\na red car\thttp://x/1.jpg\n\n"
                                     "caption with\ttab-free url\thttp://x/2.jpg\n")
    (tmp_path / "gqa.json").write_text(json.dumps({
        "q2": {"imageId": "n100", "question": "what color?", "answer": "red"},
        "q1": {"imageId": "n101", "question": "is it day?"}}))
    (tmp_path / "manifests").mkdir()
    (tmp_path / "manifests" / "b.txt").write_text("img3\nimg4\n")
    (tmp_path / "manifests" / "a.txt").write_text("img1\n\nimg2\n")
    (tmp_path / "sents").mkdir()
    (tmp_path / "anns").mkdir()
    (tmp_path / "sents" / "img1.txt").write_text(
        "[/EN#1/people a man] sees [/EN#2/animals a dog] near [/EN#3/notvisual the air]\n")
    (tmp_path / "anns" / "img1.xml").write_text("""<annotation>
  <object><name>1</name><bndbox><xmin>0</xmin><ymin>0</ymin><xmax>10</xmax><ymax>10</ymax></bndbox></object>
  <object><name>2</name><bndbox><xmin>500</xmin><ymin>500</ymin><xmax>510</xmax><ymax>510</ymax></bndbox></object>
</annotation>""")


TOOLS = {
    "coco": ("prepare_coco_captions", lambda p: (p("captions.json"),), {}),
    "vqa": ("prepare_vqa", lambda p: (p("questions.json"),), lambda p: {"annotations_json": p("annotations.json")}),
    "vqa_test": ("prepare_vqa", lambda p: (p("questions.json"),), {}),
    "nlvr2": ("prepare_nlvr2", lambda p: (p("dev.jsonl"),), {}),
    "vcr_answer": ("prepare_vcr", lambda p: (p("vcr.jsonl"),), {"mode": "answer"}),
    "vcr_rationale": ("prepare_vcr", lambda p: (p("vcr.jsonl"),), {"mode": "rationale"}),
    "conceptual_captions": ("prepare_conceptual_captions", lambda p: (p("cc.tsv"),), {"image_id_prefix": "cc_"}),
    "gqa": ("prepare_gqa", lambda p: (p("gqa.json"),), {}),
    "gqa_pretrain": ("prepare_gqa", lambda p: (p("gqa.json"),), {"style": "pretrain"}),
    "open_images": ("prepare_open_images", lambda p: (p("manifests"),), {}),
    "flickr30k_entities": ("prepare_flickr30k_entities", lambda p: (p("sents"), p("anns"), ["img1"]),
                           {"box_source": {"img1": [[0, 0, 10, 10], [100, 100, 120, 120]]}}),
}


@pytest.mark.parametrize("case", sorted(TOOLS))
def test_prepare_data_writes_what_the_jax_tool_writes(tmp_path, case):
    name, args, kw = TOOLS[case]
    tool_inputs(tmp_path)

    def p(n):
        return str(tmp_path / n)

    kw = kw(p) if callable(kw) else kw
    ours = getattr(prepare_data, name)(*args(p), p("ours.json"), **kw)
    theirs = getattr(jax_prep, name)(*args(p), p("theirs.json"), **kw)
    assert ours == theirs and ours > 0
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()


def test_convert_tsv_to_h5_writes_what_the_jax_tool_writes(tmp_path):
    """The TSV of tests/test_aux_utils.py::test_tsv_to_h5_roundtrip (and a
    row with fewer boxes), through both tools: the same datasets, bytes and
    sidecar; the port's H5Features reads it back."""
    rng = np.random.RandomState(0)

    def enc(a):
        return base64.b64encode(a.tobytes()).decode()

    rows = []
    for i, nb in enumerate((4, 4, 3)):
        obj, conf = np.arange(nb, dtype=np.int64), np.ones(nb, np.float32)
        rows.append("\t".join([f"img{i}", "480", "640", enc(obj), enc(conf), enc(obj), enc(conf), str(nb),
                               enc(rng.rand(nb, 4).astype(np.float32)), enc(rng.randn(nb, 8).astype(np.float32))]))
    tsv = tmp_path / "f.tsv"
    tsv.write_text("\n".join(rows) + "\n")
    (tmp_path / "ours").mkdir()
    (tmp_path / "theirs").mkdir()
    n = convert_tsv_to_h5.convert(str(tsv), str(tmp_path / "ours" / "f.h5"), feat_dim=8)
    assert n == jax_tsv.convert(str(tsv), str(tmp_path / "theirs" / "f.h5"), feat_dim=8) == 3
    with h5py.File(tmp_path / "ours" / "f.h5") as a, h5py.File(tmp_path / "theirs" / "f.h5") as b:
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k][()].tobytes() == b[k][()].tobytes(), k
    assert ((tmp_path / "ours" / "f_ids.json").read_text() == (tmp_path / "theirs" / "f_ids.json").read_text())
    store = H5Features(str(tmp_path / "ours" / "f.h5"))
    row = store.get("img2")
    assert row["features"].shape == (4, 8) and not row["features"][3].any() and int(row["img_h"]) == 480
    assert convert_tsv_to_h5.main([]) == 1
    assert os.path.exists(tmp_path / "ours" / "f.h5")
