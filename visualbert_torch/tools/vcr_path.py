"""The VCR train step at ``configs/vcr_finetune_qa.json``'s full size, built
for a run on one CUDA card and driven through ``Trainer``: the
counterpart of ``tools/main_path.py`` for the detector path.

The model is ``VisualBertDetectorModel`` with the config's ``model`` block
unchanged (bert-base, packed attention K1/K2, the dropout site kernels on
K3's body) and its data block's detector (ResNet50 trunk, 512-d object
representations, ``cnn_loss_ratio`` 0.1), seeded random weights; BertAdam
has the config's ``optimizer`` block with schedule "none". The batch is
the config's 32 questions: a uint8 768 x 768 canvas whose content extent
is drawn below 768 on each side (so the detector re-zeroes the padding),
20 boxes inside the content of which some are padding, their classes and
14 x 14 soft masks, 4 choices x 128 tokens and the box-token alignment.
``chip_smoke.py`` and ``tools/profile_step.py --path vcr`` both drive this.
"""

from __future__ import annotations

import os

import numpy as np

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                      "configs", "vcr_finetune_qa.json")
C, A = 4, 3  # answer choices; alignment slots a box


def config() -> dict:
    """configs/vcr_finetune_qa.json, comments stripped."""
    from visualbert_torch.utils.config_io import load_config_file

    return load_config_file(CONFIG)


def synth_batch(batch: int, image_size: int, n_boxes: int, seq_len: int, vocab: int = 30522, seed: int = 0):
    """A VCR batch as ``VCRDataset`` and ``ImageFolderStore`` make it, from
    RandomState(seed): uint8 images [B, S, S, 3] with each content extent
    drawn in [S/2, S) and zeros outside, image_hw, boxes inside the
    content with the last 0-5 of each image padded, classes, segms, C
    choices of ``seq_len`` tokens (question + answer, lengths drawn),
    alignment and labels."""
    rng = np.random.RandomState(seed)
    S, N, T = image_size, n_boxes, seq_len
    hw = rng.randint(S // 2, S, size=(batch, 2)).astype(np.int32)
    images = np.zeros((batch, S, S, 3), np.uint8)
    boxes = np.zeros((batch, N, 4), np.float32)
    box_mask = np.zeros((batch, N), np.int32)
    for b, (h, w) in enumerate(hw):
        images[b, :h, :w] = rng.randint(0, 256, size=(h, w, 3))
        n = N - rng.randint(0, 6)
        x1, y1 = rng.uniform(0, w - 16, n), rng.uniform(0, h - 16, n)
        boxes[b, :n] = np.stack([x1, y1, rng.uniform(x1 + 8, w - 1), rng.uniform(y1 + 8, h - 1)], -1)
        box_mask[b, :n] = 1
    input_mask = np.zeros((batch, C, T), np.int32)
    token_type = np.zeros((batch, C, T), np.int32)
    for b in range(batch):
        q = rng.randint(T // 8 + 1, T // 2 + 1)
        for c in range(C):
            n = rng.randint(q + 2, T + 1)
            input_mask[b, c, :n] = 1
            token_type[b, c, q:n] = 1
    alignment = np.where(rng.rand(batch, C, N, A) < 0.2, rng.randint(1, T // 2, size=(batch, C, N, A)), -1)
    return {
        "images": images,
        "image_hw": hw,
        "boxes": boxes,
        "box_mask": box_mask,
        "classes": (rng.randint(1, 81, size=(batch, N)) * box_mask).astype(np.int32),
        "segms": rng.rand(batch, N, 14, 14).astype(np.float32),
        "input_ids": (rng.randint(5, vocab, size=(batch, C, T)) * input_mask).astype(np.int32),
        "token_type_ids": token_type,
        "input_mask": input_mask,
        "image_text_alignment": alignment.astype(np.int32),
        "label": rng.randint(0, C, size=batch).astype(np.int32),
    }


def build(device="cuda", batch=None, raw=None):
    """A Trainer over the VCR model of ``raw`` (default the config file) on
    ``device``, with seeded random weights, and one synthetic batch of the
    config's shape there (``batch`` questions, default the config's)."""
    from visualbert_torch.config import OptimizerConfig, TrainConfig, VisualBertConfig
    from visualbert_torch.models.vcr import VisualBertDetectorModel
    from visualbert_torch.ops.limits import check_kernel_limits
    from visualbert_torch.train.trainer import Trainer, to_device

    raw = config() if raw is None else raw
    d = raw["data"]
    cfg = VisualBertConfig.from_dict(raw["model"])
    check_kernel_limits(cfg, device)
    model = VisualBertDetectorModel(cfg, final_dim=int(d["final_dim"]), cnn_loss_ratio=float(d["cnn_loss_ratio"]),
                                    trunk_blocks=tuple(d.get("trunk_blocks", (3, 4, 6))),
                                    layer4_blocks=int(d.get("layer4_blocks", 3)), width_div=int(d.get("width_div", 1)))
    trainer = Trainer(model, OptimizerConfig(**dict(raw["optimizer"], schedule="none")), TrainConfig(seed=0),
                      device=device).init_state()
    B = raw["train"]["train_batch_size"] if batch is None else batch
    host = synth_batch(B, int(d["image_size"]), int(d["max_boxes"]), int(d["max_seq_length"]),
                       vocab=cfg.vocab_size)
    return trainer, to_device(host, device)
