"""VCR and the detector model in the port (the ``multichoice`` head,
models/vcr.py, tools/weights.py::detector_model_state, data/datasets/vcr.py,
the detector half of data/datasets/coco.py, tools/vcr_path.py, ``to_device``
and the decay mask) against the JAX package, on the CPU; the tasks are in
tests/test_torch_vcr_tasks.py.

Batches are byte-identical to the JAX datasets', a choice cut at
``max_seq_length`` and uint8 canvases with their content extent included. A
Flax ``VisualBertDetectorModel`` loads into the port with ``strict=True``
through ``export_state_dict`` of its ``bert`` subtree,
``export_resnet50_state_dict`` of its ``detector`` subtree and
``detector_model_state``; the multichoice and the choice-less pretraining
forms agree in fp32 at atol 2e-5 / rtol 1e-4 in their outputs and every
parameter gradient, with a zero-weight row. One BertAdam step over the
model's parameters at weight decay 0.01 equals the JAX optimizer's: batch
norm scales and biases take no decay, their means and vars do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import OptimizerConfig as JaxOptimizerConfig
from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.data.datasets import coco as jax_coco
from visualbert_tpu.data.datasets import vcr as jax_vcr
from visualbert_tpu.data.features import ChunkFeatures as JaxChunkFeatures
from visualbert_tpu.data.pipeline import Batcher as JaxBatcher
from visualbert_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from visualbert_tpu.models import vcr as jax_vcr_model
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.tools.export_torch import export_resnet50_state_dict, export_state_dict
from visualbert_tpu.train.optimizer import from_config as jax_optimizer
from visualbert_tpu.train.trainer import unbox
from visualbert_torch.config import OptimizerConfig, VisualBertConfig
from visualbert_torch.data.datasets import coco, vcr
from visualbert_torch.data.features import ChunkFeatures
from visualbert_torch.data.pipeline import Batcher
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.models.vcr import VisualBertDetectorModel
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.tools import vcr_path
from visualbert_torch.tools.weights import detector_model_state, load_state
from visualbert_torch.train.optimizer import BertAdam, decays
from visualbert_torch.train.trainer import to_device
from test_torch_detector import TINY_DET, jax_7x7_stem, perturbed  # noqa: F401 (a fixture)
from test_torch_vqa import SMALL, WORDS, assert_same_batches, to_torch, tokenizers
from test_torch_vqa_advanced import TINY

ATOL, RTOL = 2e-5, 1e-4
DETECTOR_DATA = dict(final_dim=16, **{k: list(v) if isinstance(v, tuple) else v for k, v in TINY_DET.items()})


# ---- batches ----


def handmade_store(uint8, size=24):
    """Three images as ``ImageFolderStore.get`` returns them, with 2-6
    boxes: uint8 canvases with their content extent and masks, or fp32
    images without either."""
    rng = np.random.RandomState(4)
    chunk = {}
    for i, n in enumerate((2, 6, 3)):
        entry = {"boxes": rng.uniform(0, size - 4, (n, 4)).astype(np.float32), "classes": rng.randint(1, 81, n)}
        if uint8:
            entry.update(image=rng.randint(0, 256, (size, size, 3)).astype(np.uint8), height=np.int32(size - 4 - i),
                         width=np.int32(size), segms=rng.rand(n, 14, 14).astype(np.float32))
        else:
            entry["image"] = rng.randn(size, size, 3).astype(np.float32)
        chunk[str(i)] = entry
    return chunk


def vocab_words():
    return WORDS + ["person", "car", "and", "dog", "casey", "riley", "##s"]


def handmade_vcr():
    """A question with two people and an object, a choice long enough to
    be cut at max_seq_length, references beyond max_boxes."""
    return [
        {"image_id": "0", "question": ["w1", [0, 1], "w2s", "?"], "objects": ["person", "person"],
         "choices": [["w3", [1]], ["w4"] * 20, [[0], "w5"], ["w6", [1, 0], "w7"]], "label": 1},
        {"image_id": "1", "question": [[2], "w8", [5]], "objects": ["person", "car", "dog", "person", "car", "person"],
         "choices": [[[3], "w9"], [[4]], ["w10"], [[5], [0]]], "label": 3},
        {"image_id": "2", "question": ["w11"], "objects": ["car", "car", "dog"],
         "choices": [["w12"], [[0, 1, 2]], ["w13s"], [[1]]], "label": 0},
    ]


def vcr_datasets(uint8=True, pretrain=False):
    vocab = {w: i for i, w in enumerate(vocab_words())}
    chunk = handmade_store(uint8)
    kw = dict(max_seq_length=14, max_boxes=4)
    mk, mk_j = (vcr.VCRPretrainDataset, jax_vcr.VCRPretrainDataset) if pretrain else (vcr.VCRDataset,
                                                                                     jax_vcr.VCRDataset)
    ann = handmade_vcr()
    return (mk(ann, ChunkFeatures(chunk), BertTokenizer(vocab), **kw),
            mk_j(ann, JaxChunkFeatures(chunk), JaxTokenizer(vocab), **kw))


def synthetic_vcr():
    t_ours, t_theirs = tokenizers()
    ann, images = vcr.make_synthetic(12, t_ours)
    ann_j, images_j = jax_vcr.make_synthetic(12, t_theirs)
    assert ann == ann_j
    return (vcr.VCRDataset(ann, images, t_ours, max_seq_length=16, max_boxes=4),
            jax_vcr.VCRDataset(ann_j, images_j, t_theirs, max_seq_length=16, max_boxes=4))


def coco_detector_datasets():
    t_ours, t_theirs = tokenizers()
    ann, images = coco.make_synthetic_detector(12, t_ours)
    ann_j, images_j = jax_coco.make_synthetic_detector(12, t_theirs)
    assert ann == ann_j
    chunk = handmade_store(True, size=32)  # uint8 canvases: the window is the content extent
    ann = ann + [{"image_id": f"u{k}", "captions": ["w1 w2 w3", "w4 w5"]} for k in chunk]
    store = dict(images.chunk, **{f"u{k}": v for k, v in chunk.items()})
    store_j = dict(images_j.chunk, **{f"u{k}": v for k, v in chunk.items()})
    kw = dict(max_boxes=4, max_seq_length=16)
    return (coco.CocoDetectorDataset(ann, ChunkFeatures(store), t_ours, **kw),
            jax_coco.CocoDetectorDataset(ann, JaxChunkFeatures(store_j), t_theirs, **kw))


@pytest.mark.parametrize("make", [
    vcr_datasets, lambda: vcr_datasets(uint8=False), lambda: vcr_datasets(pretrain=True), synthetic_vcr,
    coco_detector_datasets], ids=["vcr_uint8", "vcr_fp32", "vcr_pretrain", "vcr_synthetic", "coco_detector"])
def test_detector_batches_are_byte_identical_to_jax(make):
    ours, theirs = make()
    tail = dict(shuffle=False, drop_last=False, pad_final=True)
    batchers = [Batcher(ours, 2, seed=3, num_workers=2), JaxBatcher(theirs, 2, seed=3, num_workers=2),
                Batcher(ours, 4, **tail), JaxBatcher(theirs, 4, **tail)]
    try:
        for epoch in (0, 1):
            assert_same_batches(batchers[0].epoch(epoch), batchers[1].epoch(epoch))
        assert_same_batches(batchers[2].epoch(0), batchers[3].epoch(0))
    finally:
        for b in batchers:
            b.close()


def test_handmade_vcr_examples():
    ours, _ = vcr_datasets()
    vocab = ours.tokenizer.vocab
    first = ours[(0, None)]
    cut = first["input_ids"][1]  # the 20-word choice is cut to fill the 14 slots
    assert first["input_mask"][1].all() and cut[-1] == vocab["[SEP]"] and list(cut).count(vocab["w4"]) > 3
    assert first["images"].dtype == np.uint8 and list(first["image_hw"]) == [20, 24]
    assert list(first["box_mask"]) == [1, 1, 0, 0] and first["segms"].shape == (4, 14, 14)
    # person 1 is "and riley" in the question and "riley" in choice 0: three aligned tokens
    assert (first["image_text_alignment"][0, 1] >= 0).sum() == 3
    second = ours[(1, None)]
    assert list(second["box_mask"]) == [1, 1, 1, 1]  # 6 boxes, 4 kept: references to 4 and 5 align nowhere
    assert second["image_text_alignment"].shape == (4, 4, 3) and (second["image_text_alignment"][:, 3] >= 0).any()
    fp32, _ = vcr_datasets(uint8=False)
    sample = fp32[(0, None)]
    assert sample["images"].dtype == np.float32 and list(sample["image_hw"]) == [24, 24] and "segms" not in sample


def test_coco_detector_window_row_covers_the_content():
    ours, _ = coco_detector_datasets()
    sample = ours[(12, np.random.default_rng(0))]  # the first uint8 canvas, content 28 x 32
    np.testing.assert_array_equal(sample["boxes"][0], [0, 0, 31, 27])
    assert sample["classes"][0] == 0 and (sample["segms"][0] == 1).all() and sample["box_mask"].sum() == 3


def test_expand_coco_matches_jax():
    train = [{"image_id": i, "captions": ["a"]} for i in range(3)]
    val = [{"image_id": i, "captions": ["b"]} for i in range(3, 8)]
    for exclude in (True, False):
        assert coco.expand_coco(train, val, [4, "6"], exclude) == jax_coco.expand_coco(train, val, [4, "6"], exclude)


# ---- models ----


def multichoice_batch(rng, tv=5):
    B, C, TT = 3, 4, 8
    input_mask = np.zeros((B, C, TT), np.int32)
    for b in range(B):
        for c in range(C):
            input_mask[b, c, : rng.randint(3, TT + 1)] = 1
    image_mask = np.ones((B, C, tv), np.int32)
    image_mask[1, :, -2:] = 0
    return {
        "input_ids": rng.randint(0, len(WORDS), (B, C, TT)).astype(np.int32),
        "token_type_ids": np.zeros((B, C, TT), np.int32),
        "input_mask": input_mask,
        "visual_embeddings": rng.randn(B, C, tv, SMALL["visual_embedding_dim"]).astype(np.float32),
        "image_mask": image_mask,
        "image_text_alignment": np.where(rng.rand(B, C, tv, 2) < 0.3, rng.randint(1, 3, (B, C, tv, 2)), -1
                                         ).astype(np.int32),
        "label": np.array([1, 3, 0], np.int32),
        "example_weight": np.array([1.0, 0.0, 1.0], np.float32),
    }


def assert_grads_match(model, want):
    names = dict(model.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want[name])
        np.testing.assert_allclose(got, want[name], atol=ATOL, rtol=RTOL, err_msg=name)


def test_multichoice_head_matches_jax(rng):
    jcfg, tcfg = JaxConfig(**TINY, dtype=jnp.float32), VisualBertConfig(**TINY, dtype=torch.float32)
    batch = multichoice_batch(rng)
    jm = JaxTask(jcfg, head_type="multichoice")
    params = unbox(jm.init(jax.random.PRNGKey(4), batch)["params"])
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch, deterministic=True)
        return out["loss"], out

    (_, out_j), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = load_state(VisualBertForTask(tcfg, "multichoice"), export_state_dict(params, jcfg))
    assert tuple(model.classifier.weight.shape) == (1, 64)
    out = model(to_torch(batch))
    out["loss"].backward()
    assert out["logits"].shape == (3, 4) and out["logits"].dtype == torch.float32
    np.testing.assert_allclose(out["logits"].detach().numpy(), out_j["logits"], atol=ATOL, rtol=RTOL)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(out[k].detach()), float(out_j[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    assert_grads_match(model, export_state_dict(grads, jcfg))


def detector_batch(rng, choices=True):
    B, N, S, TT = 2, 4, 64, 8
    shape = (B, 4, TT) if choices else (B, TT)
    input_mask = np.zeros(shape, np.int32)
    for idx in np.ndindex(*shape[:-1]):
        input_mask[idx][: rng.randint(3, TT + 1)] = 1
    batch = {
        "images": rng.randint(0, 256, (B, S, S, 3)).astype(np.uint8),
        "image_hw": np.array([[60, 64], [64, 41]], np.int32),
        "boxes": np.array([[[1, 2, 40, 50], [10, 10, 63, 63], [0, 0, 63, 59], [3, 3, 3, 3]],
                           [[5, 5, 30, 30], [20, 1, 40, 63], [0, 0, 40, 63], [0, 0, 0, 0]]], np.float32),
        "box_mask": np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.int32),
        "classes": rng.randint(0, 81, (B, N)).astype(np.int32),
        "segms": rng.rand(B, N, 14, 14).astype(np.float32),
        "input_ids": rng.randint(5, len(WORDS), shape).astype(np.int32),
        "token_type_ids": np.zeros(shape, np.int32),
        "input_mask": input_mask,
    }
    if choices:
        batch["image_text_alignment"] = np.where(rng.rand(B, 4, N, 2) < 0.3, rng.randint(1, 3, (B, 4, N, 2)),
                                                 -1).astype(np.int32)
        batch["label"] = np.array([2, 0], np.int32)
        batch["example_weight"] = np.array([1.0, 0.0], np.float32)
    else:
        lm = np.full(shape, -1, np.int32)
        lm[:, 1:4] = rng.randint(5, len(WORDS), (B, 3))
        batch.update(masked_lm_labels=lm, mlm_positions=np.tile(np.array([1, 2, 3, 0], np.int32), (B, 1)),
                     is_random_next=np.array([0, 1], np.int32))
    return batch


def jax_detector_model(jcfg, head_type):
    return jax_vcr_model.VisualBertDetectorModel(jcfg, head_type=head_type, final_dim=16, **TINY_DET)


def port_state(params, jcfg):
    return detector_model_state(export_state_dict(params["bert"], jcfg), export_resnet50_state_dict(params["detector"]))


@pytest.mark.parametrize("head_type", ["multichoice", "pretraining"])
def test_detector_model_matches_jax(rng, head_type, jax_7x7_stem):
    jcfg, tcfg = JaxConfig(**TINY, dtype=jnp.float32), VisualBertConfig(**TINY, dtype=torch.float32)
    batch = detector_batch(rng, choices=head_type == "multichoice")
    jm = jax_detector_model(jcfg, head_type)
    jbatch = jax.tree.map(jnp.asarray, batch)
    params = perturbed(unbox(jm.init(jax.random.PRNGKey(5), jbatch)["params"]), scale=0.02)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch, deterministic=True)
        return out["loss"], out

    (_, out_j), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = VisualBertDetectorModel(tcfg, head_type, final_dim=16, **TINY_DET)
    load_state(model, port_state(params, jcfg))
    out = model(to_device(batch, "cpu"))
    out["loss"].backward()
    keys = (("logits", "loss", "accuracy") if head_type == "multichoice"
            else ("logits", "loss", "masked_lm_loss", "next_sentence_loss", "mlm_accuracy"))
    for k in keys + ("cnn_regularization_loss",):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(out_j[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    want = {f"bert.{k}": v for k, v in export_state_dict(grads["bert"], jcfg).items()}
    want.update((f"detector.{k}", v) for k, v in export_resnet50_state_dict(grads["detector"]).items())
    if head_type == "pretraining":  # the tied decoder is the word table: one parameter in the port
        want.pop("bert.cls.predictions.decoder.weight")
    assert_grads_match(model, want)


def test_flax_detector_model_loads_strict(rng, jax_7x7_stem):
    jcfg = JaxConfig(**TINY, dtype=jnp.float32)
    params = unbox(jax_detector_model(jcfg, "multichoice").init(
        jax.random.PRNGKey(6), jax.tree.map(jnp.asarray, detector_batch(rng)))["params"])
    state = port_state(params, jcfg)
    model = VisualBertDetectorModel(VisualBertConfig(**TINY, dtype=torch.float32), final_dim=16, **TINY_DET)
    load_state(model, state)
    np.testing.assert_array_equal(model.detector.layer1[0].bn2.running_var.detach().numpy(),
                                  np.asarray(params["detector"]["backbone"]["layer1"]["block0"]["bn2"]["var"]))
    with pytest.raises(RuntimeError):
        load_state(model, {k: v for k, v in state.items() if not k.startswith("detector.mask_upsample")})


def test_bert_adam_step_matches_jax_over_the_detector_model(jax_7x7_stem):
    """Two updates at weight decay 0.01 with the gradients clipped by
    max_grad_norm: the batch norms' scales and biases take no decay, their
    means and vars do, as in JAX's decay mask."""
    jcfg = JaxConfig(**TINY, dtype=jnp.float32)
    rng = np.random.RandomState(12)
    params = perturbed(unbox(jax_detector_model(jcfg, "multichoice").init(
        jax.random.PRNGKey(7), jax.tree.map(jnp.asarray, detector_batch(rng)))["params"]), scale=0.5)
    grads = [jax.tree_util.tree_map(lambda x: jnp.asarray(rng.randn(*x.shape), x.dtype), params) for _ in range(2)]
    kw = dict(learning_rate=1e-2, schedule="none", weight_decay=0.01, max_grad_norm=1.0)
    model = VisualBertDetectorModel(VisualBertConfig(**TINY, dtype=torch.float32), final_dim=16, **TINY_DET)
    load_state(model, port_state(params, jcfg))
    opt = BertAdam(model.named_parameters(), OptimizerConfig(**kw))
    assert not opt.decay["detector.layer2.0.bn1.weight"] and not opt.decay["detector.layer2.0.downsample.1.weight"]
    assert opt.decay["detector.layer2.0.bn1.running_mean"] and opt.decay["detector.layer2.0.downsample.0.weight"]
    tx = jax_optimizer(JaxOptimizerConfig(**kw))
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        g_port = port_state(g, jcfg)
        for name, p in model.named_parameters():
            p.grad = torch.tensor(g_port[name])
        opt.step()
    want = port_state(params, jcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6, rtol=1e-5, err_msg=name)


def test_decay_mask_names():
    no_decay = OptimizerConfig().no_decay
    for name in ("detector.bn1.weight", "detector.layer3.5.bn3.weight", "detector.layer4.0.downsample.1.weight",
                 "detector.layer1.0.bn1.bias", "detector.mask_upsample.bias", "bert.bert.encoder.layer.0.output.LayerNorm.weight"):
        assert not decays(name, no_decay), name
    for name in ("detector.bn1.running_mean", "detector.layer1.0.bn2.running_var", "detector.conv1.weight",
                 "detector.layer2.0.downsample.0.weight", "detector.object_embed.weight",
                 "bert.bert.embeddings.word_embeddings.weight", "bert.classifier.weight"):
        assert decays(name, no_decay), name


def test_to_device_keeps_images_in_their_wire_dtype():
    batch = {"images": np.zeros((2, 4, 4, 3), np.uint8), "image_hw": np.ones((2, 2), np.int32),
             "box_mask": np.ones((2, 3), np.uint8), "segms": np.zeros((2, 3, 14, 14), np.float32), "_real_count": 2}
    out = to_device(batch, "cpu")
    assert out["images"].dtype == torch.uint8 and out["image_hw"].dtype == torch.int64
    assert out["box_mask"].dtype == torch.int64 and out["segms"].dtype == torch.float32 and "_real_count" not in out
    assert to_device({"images": np.zeros((1, 2, 2, 3), np.float32)}, "cpu")["images"].dtype == torch.float32


def test_vcr_path_batch_at_a_small_size():
    b = vcr_path.synth_batch(3, 64, 6, 16, vocab=50)
    assert b["images"].dtype == np.uint8 and b["images"].shape == (3, 64, 64, 3)
    for img, (h, w), bx, m in zip(b["images"], b["image_hw"], b["boxes"], b["box_mask"]):
        assert 32 <= h < 64 and 32 <= w < 64 and not img[h:].any() and not img[:, w:].any()
        real = bx[m == 1]
        assert (real[:, 2] > real[:, 0]).all() and (real[:, 2] <= w - 1).all() and (real[:, 3] <= h - 1).all()
        assert not bx[m == 0].any()
    assert b["input_ids"].shape == (3, 4, 16) and b["image_text_alignment"].shape == (3, 4, 6, 3)
    raw = vcr_path.config()
    assert raw["model"] == {"visual_embedding_dim": 512, "use_flash_attention": True, "fast_dropout": True}
    raw["model"] = dict(raw["model"], **{k: v for k, v in TINY.items() if k != "visual_embedding_dim"},
                        dtype="float32")
    raw["data"] = dict(raw["data"], image_size=64, max_seq_length=16, **DETECTOR_DATA)
    trainer, batch = vcr_path.build("cpu", batch=2, raw=raw)
    assert trainer.optimizer.cfg.schedule == "none" and trainer.optimizer.cfg.learning_rate == 2e-5
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(2)]
    assert all(np.isfinite(losses)) and batch["images"].dtype == torch.uint8
