"""The unsupervised pretraining step at ``configs/unsup_pretrain.json``'s full
width, built for a run on one CUDA card and driven through ``Trainer``: the
counterpart of ``tools/main_path.py`` for the unsupervised stack.

The model is ``UnsupervisedVisualBert`` with the config's ``model`` block
unchanged (bert-base, packed attention K1/K2, the 24 dropout sites of the
encoder on K3's body, the fused MLM cross-entropy K4-K6 over every text
row), the BUTD vocabularies' sizes that the synthetic names stand in for
(1600 objects, 400 attributes: 2003 symbols), 2048-d region features and
seeded random weights; BertAdam has the config's ``optimizer`` block with
schedule "none". Two batches of the config's 144 rows make the hybrid mix:
a V&L batch of 30 text tokens (ragged), 36 tags and 36 regions (T = 102),
a text-only batch at the task's default ``text_seq_length`` of 64, and the
image-only batch (the V&L batch's tags and regions without its text, T =
72), the three sources of the hybrid mix.
``chip_smoke.py`` and ``tools/profile_step.py --path unsup`` both drive
this.
"""

from __future__ import annotations

import os

import numpy as np

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "configs", "unsup_pretrain.json")
N_OBJ, N_ATTR = 1600, 400  # BUTD's object and attribute vocabularies
TEXT_SEQ_LENGTH = 64  # run_unsup_pretrain's default text_seq_length
MASK_PROB = 0.15


def config() -> dict:
    """configs/unsup_pretrain.json, comments stripped."""
    from visualbert_torch.utils.config_io import load_config_file

    return load_config_file(CONFIG)


def text_rows(rng, B, T, lengths, vocab):
    """[CLS] tokens [SEP] rows of the given lengths, MLM labels on 15% of
    the tokens between (-1 elsewhere, padding included)."""
    ids = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T), np.int32)
    lm = np.full((B, T), -1, np.int32)
    for b, n in enumerate(lengths):
        ids[b, :n] = rng.randint(5, vocab, n)
        ids[b, 0], ids[b, n - 1] = 101, 102
        mask[b, :n] = 1
        picked = 1 + np.flatnonzero(rng.rand(n - 2) < MASK_PROB)
        lm[b, picked] = ids[b, picked]
        ids[b, picked] = 103
    return {"input_ids": ids, "token_type_ids": np.zeros((B, T), np.int32), "input_mask": mask,
            "masked_lm_labels": lm}


def synth_batches(batch: int, seq_len: int, n_regions: int, feat_dim: int = 2048, vocab: int = 30522, seed: int = 0):
    """(V&L batch, text-only batch) in the fields and proportions that
    ``UnsupervisedPretrainDataset`` and ``TextOnlyDataset`` give, from
    RandomState(seed): text lengths drawn, 15% of regions masked (their
    features zeroed, their objects, attributes and features the targets),
    tags with 15% masked, half the pairs mismatched."""
    rng = np.random.RandomState(seed)
    B, T, N = batch, seq_len, n_regions
    vl = text_rows(rng, B, T, rng.randint(6, T + 1, B), vocab)
    feats = rng.randn(B, N, feat_dim).astype(np.float32)
    fm = (rng.rand(B, N) < MASK_PROB).astype(np.float32)
    obj, attr = rng.randint(0, N_OBJ, (B, N)), rng.randint(0, N_ATTR, (B, N))
    boxes = np.sort(rng.rand(B, N, 4).astype(np.float32), axis=-1)
    tags = obj.astype(np.int32)
    tag_masked = (rng.rand(B, N) < MASK_PROB) | ((fm > 0) & (rng.rand(B, N) < 0.5))
    vl.update(
        visual_feats=np.where(fm[..., None] > 0, 0.0, feats).astype(np.float32), boxes=boxes,
        visual_feats_mask=np.ones((B, N), np.int32),
        obj_labels=np.where(fm > 0, obj, -1).astype(np.int32), obj_conf=fm * rng.rand(B, N).astype(np.float32),
        attr_labels=np.where(fm > 0, attr, -1).astype(np.int32), attr_conf=fm * rng.rand(B, N).astype(np.float32),
        feat_target=feats, feat_mask=fm,
        visual_tags=np.where(tag_masked, N_OBJ + N_ATTR + 2, tags).astype(np.int32), visual_tags_box=boxes,
        visual_tags_mask=np.ones((B, N), np.int32),
        visual_tags_objective=np.where(tag_masked, tags, -1).astype(np.int32),
        matched_label=rng.randint(0, 2, B).astype(np.int32),
    )
    text = text_rows(rng, B, TEXT_SEQ_LENGTH, rng.randint(TEXT_SEQ_LENGTH // 2, TEXT_SEQ_LENGTH + 1, B), vocab)
    return vl, text


def build(device="cuda", batch=None, raw=None):
    """A Trainer over ``UnsupervisedVisualBert`` of ``raw`` (default the
    config file) on ``device``, with seeded random weights, and the V&L,
    text-only and image-only batches of the config's shape there (``batch``
    rows, default the config's): ``(trainer, {"vl": ..., "text": ...,
    "image": ...})``."""
    from visualbert_torch.config import OptimizerConfig, TrainConfig, VisualBertConfig
    from visualbert_torch.models.unsupervised import UnsupervisedConfig, UnsupervisedVisualBert
    from visualbert_torch.ops.limits import check_kernel_limits
    from visualbert_torch.train.trainer import Trainer, to_device

    raw = config() if raw is None else raw
    d = raw["data"]
    cfg = VisualBertConfig.from_dict(raw["model"])
    check_kernel_limits(cfg, device)
    ucfg = UnsupervisedConfig(bert=cfg, visual_feat_dim=cfg.visual_embedding_dim, obj_id_num=N_OBJ,
                              attr_id_num=N_ATTR, symbolic_vocab_size=N_OBJ + N_ATTR + 3)
    trainer = Trainer(UnsupervisedVisualBert(ucfg), OptimizerConfig(**dict(raw["optimizer"], schedule="none")),
                      TrainConfig(seed=0), device=device).init_state()
    B = raw["train"]["train_batch_size"] if batch is None else batch
    vl, text = synth_batches(B, int(d["max_seq_length"]), int(d["n_regions"]), feat_dim=cfg.visual_embedding_dim,
                             vocab=cfg.vocab_size)
    image = {k: v for k, v in vl.items() if k not in text and k != "matched_label"}
    return trainer, {"vl": to_device(vl, device), "text": to_device(text, device), "image": to_device(image, device)}
