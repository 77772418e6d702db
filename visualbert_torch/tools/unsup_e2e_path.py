"""The end-to-end unsupervised pretraining step (the detector in the training
graph, BASELINE.json config 5) at full width, built for a run on one CUDA
card and driven through ``Trainer``: the counterpart of
``tools/unsup_path.py`` for ``UnsupervisedEndToEnd``.

The model is ``UnsupervisedEndToEnd`` with configs/unsup_pretrain.json's
``model`` block unchanged (bert-base, packed attention K1/K2, the encoder's
24 dropout sites on K3's body, the fused MLM cross-entropy K4-K6 over every
text row), the BUTD vocabularies' sizes (1600 objects, 400 attributes: 2003
symbols), the full ResNet50 detector (7 x 7 stem, layers (3, 4, 6), layer4
of 3 blocks, width_div 1; 2048-d object features) and the 81 detector
classes mapped onto the first 81 symbols; seeded random weights; BertAdam
has the config's ``optimizer`` block with schedule "none".

The batch holds uint8 768 x 768 canvases (the detector's wire format and
configs/vcr_finetune_qa.json's ``image_size``), 36 boxes an image (the
config's ``n_regions``) with their normalized copies, 30 text tokens (the
config's ``max_seq_length``, lengths drawn) with 15 % MLM labels,
``matched_label`` at 0.5, and ``feat_mask`` drawn at 15 % with ``tag_mask``
equal to it (the model masks features and tags jointly). It is cut from
the config's 144 rows to BATCH = 32: one card does not hold the detector
over 144 images of 768 x 768 (the VCR step at 32 images and 20 boxes peaks
at 32 GiB). ``chip_smoke.py`` and ``tools/profile_step.py --path
unsup_e2e`` both drive this.
"""

from __future__ import annotations

import numpy as np

from visualbert_torch.tools import unsup_path

BATCH = 32  # cut from the config's 144: the detector over 768 x 768 images
IMAGE_SIZE = 768  # configs/vcr_finetune_qa.json's image_size
N_CLASSES = 81  # the detector's classes
MASK_PROB = 0.15


def config() -> dict:
    """configs/unsup_pretrain.json, comments stripped."""
    return unsup_path.config()


def synth_batch(batch: int, image_size: int, n_boxes: int, seq_len: int, vocab: int = 30522, seed: int = 0):
    """An end-to-end batch from RandomState(seed): uint8 images [B, S, S, 3],
    ``n_boxes`` boxes inside each image (pixels and normalized), text rows
    of drawn lengths with 15 % MLM labels, matched labels at 0.5, and the
    feature and tag masks drawn jointly at 15 %."""
    rng = np.random.RandomState(seed)
    S, N = image_size, n_boxes
    x1, y1 = rng.uniform(0, S - 16, (batch, N)), rng.uniform(0, S - 16, (batch, N))
    boxes = np.stack([x1, y1, rng.uniform(x1 + 8, S - 1), rng.uniform(y1 + 8, S - 1)], -1).astype(np.float32)
    out = unsup_path.text_rows(rng, batch, seq_len, rng.randint(6, seq_len + 1, batch), vocab)
    feat_mask = (rng.rand(batch, N) < MASK_PROB).astype(np.int32)
    out.update(
        images=rng.randint(0, 256, (batch, S, S, 3)).astype(np.uint8),
        boxes=boxes,
        boxes_norm=boxes / np.float32(S),
        box_mask=np.ones((batch, N), np.int32),
        matched_label=(rng.rand(batch) < 0.5).astype(np.int32),
        feat_mask=feat_mask,
        tag_mask=feat_mask.copy(),
    )
    return out


def build(device="cuda", batch=None, raw=None, image_size=IMAGE_SIZE, trunk_blocks=(3, 4, 6), layer4_blocks=3,
          width_div=1):
    """A Trainer over ``UnsupervisedEndToEnd`` of ``raw`` (default the config
    file) on ``device``, with seeded random weights, and one synthetic batch
    there (``batch`` rows, default BATCH). The detector knobs and the image
    size shrink it for tests."""
    from visualbert_torch.config import OptimizerConfig, TrainConfig, VisualBertConfig
    from visualbert_torch.models.unsup_e2e import UnsupervisedEndToEnd
    from visualbert_torch.models.unsupervised import UnsupervisedConfig
    from visualbert_torch.ops.limits import check_kernel_limits
    from visualbert_torch.train.trainer import Trainer, to_device

    raw = config() if raw is None else raw
    d = raw["data"]
    cfg = VisualBertConfig.from_dict(raw["model"])
    check_kernel_limits(cfg, device)
    n_obj, n_attr = unsup_path.N_OBJ, unsup_path.N_ATTR
    ucfg = UnsupervisedConfig(bert=cfg, visual_feat_dim=2048 // width_div, obj_id_num=n_obj, attr_id_num=n_attr,
                              symbolic_vocab_size=n_obj + n_attr + 3)
    model = UnsupervisedEndToEnd(ucfg, class_to_symbolic=tuple(range(N_CLASSES)), trunk_blocks=trunk_blocks,
                                 layer4_blocks=layer4_blocks, width_div=width_div)
    trainer = Trainer(model, OptimizerConfig(**dict(raw["optimizer"], schedule="none")), TrainConfig(seed=0),
                      device=device).init_state()
    host = synth_batch(BATCH if batch is None else batch, image_size, int(d["n_regions"]), int(d["max_seq_length"]),
                       vocab=cfg.vocab_size)
    return trainer, to_device(host, device)
