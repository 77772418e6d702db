"""Tasks: build (model, datasets) for a task and run the fit loop
(counterpart of ``visualbert_tpu/tasks/registry.py``; the reference's
``visualbert/models/train.py`` dataset dispatch, train.py:148-191).

The port has all eleven tasks of the JAX registry: ``coco_pretrain``,
``vcr_coco_pretrain``, ``vqa``, ``vqa_advanced``, ``nlvr2``, ``flickr``,
``flickr_probe``, ``vcr``, ``text_pretrain``, ``unsup_pretrain`` and
``unsup_vqa``. A task supports ``data: {"synthetic": N}`` for smoke runs and
real-data paths (documented per task; HDF5 features through ``H5Features``,
which needs h5py).
Every task runs on the device it is given: ``"cuda"`` for the kernels,
``"cpu"`` for their plain versions.

Under a multi-rank launch (``parallel/distributed.py``) every task builds
its Trainer on ``create_mesh(cfg.train.mesh_shape)`` (JAX ``:69-84``) and
every Batcher keeps the rank's data slice of each global batch. Evaluation
metrics are global and exact; each rank dumps its own slice of the eval
split (its real rows only) into ``<folder>/rank_<r>``, as JAX documents
for its hosts (``docs/DISTRIBUTED.md`` "Caveats"), so a dump file, and the
numbers a dump hook adds (NLVR2's official accuracy, Flickr30k's recall),
cover that rank's slice; ``--eval_only`` on one process gives one file.
Rank 0 writes the checkpoints and the run log.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict

import numpy as np
import torch

from visualbert_torch.data.pipeline import Batcher, prefetch
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.ops.limits import check_kernel_limits
from visualbert_torch.parallel import distributed
from visualbert_torch.parallel.mesh import all_reduce_numbers, create_mesh
from visualbert_torch.train import loop
from visualbert_torch.train.loop import FitResult, fit
from visualbert_torch.train.trainer import Trainer
from visualbert_torch.utils.checkpoint import CheckpointManager, load_trainer_state
from visualbert_torch.utils.config_io import TaskConfig
from visualbert_torch.utils.logging import add_run_folder, get_logger

log = get_logger(__name__)

TASKS: Dict[str, Callable] = {}


def register(name):
    def deco(fn):
        TASKS[name] = fn
        return fn

    return deco


def _tokenizer(cfg: TaskConfig) -> BertTokenizer:
    vocab_file = cfg.data.get("vocab_file")
    if vocab_file:
        # the native WordPiece path, byte-exact with the Python tokenizer
        # (non-ASCII strings go to the Python one)
        from visualbert_torch.data.fast_tokenizer import FastBertTokenizer

        return FastBertTokenizer.from_file(vocab_file)
    if "synthetic" not in cfg.data:
        # training over the toy vocabulary would silently produce garbage
        raise ValueError(
            "data.vocab_file is required for real-data configs (the synthetic toy vocabulary is only "
            "used when data.synthetic is set); point it at the bert-base-uncased vocab.txt"
        )
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "?"] + [f"w{i}" for i in range(100)]
    return BertTokenizer({w: i for i, w in enumerate(words)})


def _trainer(cfg: TaskConfig, model, device) -> Trainer:
    """The task's Trainer on this rank's place in ``cfg.train.mesh_shape``
    (collective: every rank calls it once)."""
    check_kernel_limits(cfg.model, device)
    return Trainer(model, cfg.optimizer, cfg.train, device=device, mesh=create_mesh(cfg.train.mesh_shape))


def _process_shard(trainer: Trainer):
    """``Batcher(process_shard=...)`` of this rank: its data slice of every
    global batch, or None on one data rank (or a Trainer without a mesh)."""
    return None if trainer.mesh is None else trainer.mesh.batch_shard()


def _default_frozen_pooler(cfg: TaskConfig) -> TaskConfig:
    """Pretraining tasks: the reference excludes the pooler from
    optimization (model_wrapper.py:104). Applied only when the config left
    ``optimizer.frozen`` unset (None); an explicit ``[]`` trains everything."""
    if cfg.optimizer.frozen is not None:
        return cfg
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(cfg.optimizer, frozen=("pooler",)))


def _restore(cfg: TaskConfig, trainer: Trainer) -> Trainer:
    """Load a checkpoint: a reference torch file (``.th``/``.pth``/``.bin``),
    into the parameters that the JAX registry's ``_restore`` loads from it
    (``tools/import_torch.py::restore_torch_file``), or the port's own, a
    checkpoint directory (its latest step) or one ``step_<N>.pt`` /
    ``best.pt`` file."""
    path = cfg.restore_checkpoint
    if path.endswith((".th", ".pth", ".bin")):
        from visualbert_torch.tools.import_torch import restore_torch_file

        with trainer.gathered():  # the reference layout holds whole tensors
            loaded = restore_torch_file(trainer.model, path, cfg.model)
        log.info("restored torch checkpoint %s: %d leaves of the Flax layout loaded", path, len(loaded))
        return trainer
    if os.path.isdir(path):
        path = CheckpointManager(path).path()
    load_trainer_state(trainer, path)
    log.info("restored checkpoint %s (step %d)", path, trainer.step)
    return trainer


def _features(d):
    """A task's region features: ``features_h5`` (``H5Features``, an HDF5
    file with its id sidecar) or ``features_dir`` (``<image_id>.npy``)."""
    from visualbert_torch.data.features import H5Features, NpyFolderFeatures

    return H5Features(d["features_h5"]) if "features_h5" in d else NpyFolderFeatures(d["features_dir"])


def _json(path):
    with open(path) as f:
        return json.load(f)


def _run_fit(cfg: TaskConfig, trainer: Trainer, train_ds, eval_ds=None, dump_hook=None, val_metric="accuracy",
             val_metric_higher_is_better=None, out_select=None):
    """Fit ``trainer`` on ``train_ds``, evaluating ``eval_ds`` after each
    epoch and checkpointing into ``<folder>/ckpt``; then, with a
    ``dump_hook``, write the eval split's predictions (JAX
    ``registry.py:100-148``). With ``eval_only``: restore, evaluate, dump.
    ``val_metric`` selects the best epoch; it counts as lower-is-better when
    it is ``"loss"`` unless ``val_metric_higher_is_better`` says otherwise.
    ``out_select`` is :func:`evaluate`'s."""
    if val_metric_higher_is_better is None:
        val_metric_higher_is_better = val_metric != "loss"
    if cfg.eval_only and eval_ds is None:
        raise ValueError(f"eval_only needs an eval split; task {cfg.task} has none")
    trainer.init_state()
    if cfg.restore_checkpoint:
        _restore(cfg, trainer)
    shard = _process_shard(trainer)
    train_b = Batcher(train_ds, cfg.train.train_batch_size, seed=cfg.train.seed, num_workers=cfg.train.num_workers,
                      process_shard=shard)
    eval_b = None
    if eval_ds is not None:
        eval_b = Batcher(eval_ds, cfg.train.eval_batch_size, shuffle=False, seed=cfg.train.seed, drop_last=False,
                         pad_final=True, num_workers=cfg.train.num_workers, process_shard=shard)
    try:
        if cfg.eval_only:
            metrics = evaluate(trainer, eval_b, dump_hook, cfg.folder, out_select)
            return trainer, FitResult(best_metric=metrics.get(val_metric, float("nan")), best_epoch=-1,
                                      epochs_run=0, history=[metrics])
        result = fit(trainer, lambda e: prefetch(train_b.epoch(e)),
                     (lambda: eval_b.epoch(0)) if eval_b is not None else None,
                     checkpoint_dir=os.path.join(cfg.folder, "ckpt"), val_metric=val_metric,
                     val_metric_higher_is_better=val_metric_higher_is_better)
        if dump_hook is not None and eval_b is not None:
            evaluate(trainer, eval_b, dump_hook, cfg.folder, out_select)
    finally:
        train_b.close()
        if eval_b is not None:
            eval_b.close()
    return trainer, result


def evaluate(trainer: Trainer, eval_b: Batcher, dump_hook, folder: str, out_select=None) -> Dict[str, float]:
    """Run the eval split once: the scalar metrics, and every (batch,
    outputs) pair, outputs as numpy, handed to ``dump_hook(collected,
    folder)`` for the prediction files (JAX ``registry.py:151-215``, one
    process). ``out_select(outputs) -> outputs`` reduces the outputs on
    their device before the host copy (``vqa_advanced``'s argmax over
    [B, P, 30522] logits). Under a multi-rank launch the scalar metrics are
    global; the hook sees this rank's rows, each batch's ``_real_count``
    the rank's own real rows (the tail-pad repeats trimmed per rank), and
    writes into ``<folder>/rank_<r>``."""
    collected = []
    sharded = eval_b.process_shard is not None

    def collect(batch, out):
        if dump_hook is not None:
            if out_select is not None:
                out = out_select(out)
            if sharded:
                batch = dict(batch, _real_count=float(np.sum(batch["example_weight"])))
            collected.append((batch, {k: v.detach().cpu().numpy() for k, v in out.items() if v is not None}))

    metrics = loop.evaluate(trainer, eval_b.epoch(0), collect)
    if dump_hook is not None:
        if distributed.is_distributed():
            folder = os.path.join(folder, f"rank_{distributed.rank()}")
            os.makedirs(folder, exist_ok=True)
        metrics.update(dump_hook(collected, folder) or {})
    log.info("eval: %s", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


# ---- tasks ----


@register("coco_pretrain")
def run_coco_pretrain(cfg: TaskConfig, device):
    """COCO-caption MLM + sentence-image alignment pretraining. Real data:
    ``annotations`` (a json list of {"image_id", "captions"}), region
    features in ``features_h5`` or ``features_dir`` and ``vocab_file``."""
    from visualbert_torch.data.datasets import coco as coco_ds

    tok = _tokenizer(cfg)
    d = cfg.data
    if "synthetic" in d:
        ann, feats = coco_ds.make_synthetic(int(d["synthetic"]), tok, feat_dim=cfg.model.visual_embedding_dim)
    else:
        ann, feats = _json(d["annotations"]), _features(d)
    ds = coco_ds.CocoCaptionsDataset(
        ann, feats, tok,
        max_seq_length=int(d.get("max_seq_length", 128)),
        max_regions=int(d.get("max_regions", 100)),
        two_sentence=bool(d.get("two_sentence", True)),
    )
    model = VisualBertForTask(cfg.model, head_type="pretraining")
    cfg = _default_frozen_pooler(cfg)
    return _run_fit(cfg, _trainer(cfg, model, device), ds, val_metric="loss")


def _detector_store(d):
    """A detector task's real-data image store: raw jpgs with json metadata
    in ``images_dir`` (``ImageFolderStore``, which reads them with PIL;
    ``class_names`` one a line), or ``<image_id>.npy`` dicts of the same
    fields in ``preprocessed_dir`` (``NpyFolderFeatures``)."""
    if "images_dir" not in d:
        from visualbert_torch.data.features import NpyFolderFeatures

        return NpyFolderFeatures(d["preprocessed_dir"])
    from visualbert_torch.utils.images import ImageFolderStore

    class_names = None
    if "class_names" in d:
        with open(d["class_names"]) as f:
            class_names = [line.strip() for line in f if line.strip()]
    return ImageFolderStore(d["images_dir"], target=int(d.get("image_size", 768)), class_names=class_names)


def _detector_model(cfg: TaskConfig, head_type: str):
    """``VisualBertDetectorModel`` with the detector knobs of the data block
    (``final_dim``, ``cnn_loss_ratio``, ``trunk_blocks``, ``layer4_blocks``,
    ``width_div``), as the JAX registry reads them."""
    from visualbert_torch.models.vcr import VisualBertDetectorModel

    d = cfg.data
    return VisualBertDetectorModel(
        cfg.model, head_type=head_type, final_dim=int(d.get("final_dim", 512)),
        cnn_loss_ratio=float(d.get("cnn_loss_ratio", 0.1)), trunk_blocks=tuple(d.get("trunk_blocks", (3, 4, 6))),
        layer4_blocks=int(d.get("layer4_blocks", 3)), width_div=int(d.get("width_div", 1)),
    )


@register("vcr_coco_pretrain")
def run_vcr_coco_pretrain(cfg: TaskConfig, device):
    """COCO-caption MLM + alignment pretraining through the detector (the
    VCR pipeline's pretraining stage: reference r2c mode,
    coco_dataset.py:235-340, configs/vcr/coco-pre-train.json). Synthetic
    data (32 x 32 images, 3 boxes) is split 80/20; real data:
    ``train_annotations`` and optionally ``eval_annotations`` (json lists of
    {"image_id", "captions"}), ``images_dir`` (``ImageFolderStore``) or
    ``preprocessed_dir`` (``<image_id>.npy`` dicts of the store's fields),
    ``vocab_file``, and the reference's ``expand_coco`` (train + val minus
    ``minival_image_ids``). The pooler is frozen unless the config says
    otherwise; the best epoch is the one of the lowest val loss."""
    from visualbert_torch.data.datasets import coco as coco_ds

    tok = _tokenizer(cfg)
    d = cfg.data
    if "synthetic" in d:
        ann, images = coco_ds.make_synthetic_detector(int(d["synthetic"]), tok)
        split = int(len(ann) * 0.8)
        train_ann, eval_ann = ann[:split], ann[split:]
    else:
        train_ann = _json(d["train_annotations"])
        eval_ann = _json(d["eval_annotations"]) if "eval_annotations" in d else None
        if d.get("expand_coco") and eval_ann is not None:
            train_ann, eval_ann = coco_ds.expand_coco(train_ann, eval_ann, _json(d["minival_image_ids"]),
                                                      exclude_minival=bool(d.get("exclude_minival", True)))
        images = _detector_store(d)

    def mk(ann):
        return coco_ds.CocoDetectorDataset(ann, images, tok, max_boxes=int(d.get("max_boxes", 20)),
                                           max_seq_length=int(d.get("max_seq_length", 128)),
                                           two_sentence=bool(d.get("two_sentence", True)))

    model = _detector_model(cfg, "pretraining")
    cfg = _default_frozen_pooler(cfg)
    return _run_fit(cfg, _trainer(cfg, model, device), mk(train_ann), mk(eval_ann) if eval_ann else None,
                    val_metric="loss")


@register("vcr")
def run_vcr(cfg: TaskConfig, device):
    """VCR Q->A (or QA->R) fine-tuning end to end: the detector over the
    raw image and the ``multichoice`` head over 4 choices. Synthetic data
    (32 x 32 images, 3 boxes, the bright box names the answer) is split
    80/20; real data: ``train_annotations`` and ``eval_annotations`` (json
    lists of {"image_id", "question", "choices", "label", "objects"}),
    ``images_dir`` (raw jpgs + json metadata, ``ImageFolderStore``) or
    ``preprocessed_dir`` (``NpyFolderFeatures``), ``class_names`` and
    ``vocab_file``. Each evaluation after training, or alone with
    ``eval_only``, writes ``vcr_logits.npy`` ([questions, 4] fp32)."""
    from visualbert_torch.data.datasets import vcr as vcr_ds

    tok = _tokenizer(cfg)
    d = cfg.data
    if "synthetic" in d:
        ann, images = vcr_ds.make_synthetic(int(d["synthetic"]), tok)
        split = int(len(ann) * 0.8)
        train_ann, eval_ann = ann[:split], ann[split:]
    else:
        train_ann, eval_ann = _json(d["train_annotations"]), _json(d["eval_annotations"])
        images = _detector_store(d)

    def mk(ann):
        return vcr_ds.VCRDataset(ann, images, tok, max_seq_length=int(d.get("max_seq_length", 128)),
                                 max_boxes=int(d.get("max_boxes", 20)))

    model = _detector_model(cfg, "multichoice")
    return _run_fit(cfg, _trainer(cfg, model, device), mk(train_ann), mk(eval_ann), dump_hook=vcr_dump_hook)


def vcr_dump_hook(collected, folder):
    """The dump hook of ``vcr``: ``vcr_logits.npy``, the per-choice logits
    of each eval question for the leaderboard tooling (reference
    train.py:352-368). The repeated tail rows of the last eval batch are not
    questions and are left out (the JAX hook writes them too)."""
    logits = [np.asarray(out["logits"][: int(batch.get("_real_count", len(out["logits"])))], np.float32)
              for batch, out in collected]
    if logits:
        np.save(os.path.join(folder, "vcr_logits.npy"), np.concatenate(logits))
    return {}


@register("vqa")
def run_vqa(cfg: TaskConfig, device):
    """VQA fine-tuning with the soft-score classifier. Synthetic data is
    split 80/20 into train and eval; real data: ``train_annotations`` and
    ``eval_annotations`` (imdb-style json lists), region features in
    ``features_h5`` or ``features_dir``, ``answer_vocab`` (one answer a
    line, or a json list) and ``vocab_file``. Each evaluation writes
    ``vqa_predictions.json`` ([{"question_id", "answer"}]) into the run
    folder after training, or alone with ``eval_only``."""
    from visualbert_torch.data.datasets import vqa as vqa_ds

    tok = _tokenizer(cfg)
    d = cfg.data
    if "synthetic" in d:
        ann, feats, vocab = vqa_ds.make_synthetic(int(d["synthetic"]), tok, n_answers=int(d.get("n_answers", 16)),
                                                  feat_dim=cfg.model.visual_embedding_dim)
        split = int(len(ann) * 0.8)
        train_ann, eval_ann = ann[:split], ann[split:]
    else:
        train_ann, eval_ann, feats = _json(d["train_annotations"]), _json(d["eval_annotations"]), _features(d)
        vocab = vqa_ds.AnswerVocab.from_file(d["answer_vocab"])

    def mk(ann):
        return vqa_ds.VQADataset(ann, feats, tok, vocab, max_seq_length=int(d.get("max_seq_length", 128)),
                                 max_regions=int(d.get("max_regions", 100)))

    model = VisualBertForTask(cfg.model, head_type="vqa", num_answers=len(vocab))
    return _run_fit(cfg, _trainer(cfg, model, device), mk(train_ann), mk(eval_ann), dump_hook=vqa_dump_hook(vocab))


def vqa_dump_hook(vocab):
    """The dump hook of ``vqa``: ``vqa_predictions.json``, the leaderboard
    json (reference vqa_dataset.py:290-302), one entry a question. The
    repeated tail rows of the last eval batch are not questions and are
    left out (the JAX hook writes them too)."""
    from visualbert_torch.data.datasets.vqa import VQAEvaluator

    def dump(collected, folder):
        qids, logits = [], []
        for batch, out in collected:
            n = int(batch.get("_real_count", len(batch["question_id"])))
            qids.extend(int(q) for q in batch["question_id"][:n])
            logits.append(np.asarray(out["logits"][:n], np.float32))
        if logits:
            VQAEvaluator(vocab).dump(qids, np.concatenate(logits), os.path.join(folder, "vqa_predictions.json"))
        return {}

    return dump


@register("vqa_advanced")
def run_vqa_advanced(cfg: TaskConfig, device):
    """VQA answer-as-MLM (reference head modeling.py:1527-1554, dataset mode
    vqa_dataset.py:158-184): the answer's wordpieces sit in ``[MASK]`` slots
    after the question and the tied MLM head predicts them, through the
    fused cross-entropy (K4-K6) in training and the decoder's logits in
    evaluation. The best epoch is the one of the highest masked-token
    accuracy (``mlm_accuracy``). Synthetic data is split 80/20; real data as
    ``vqa``'s, without ``answer_vocab`` (the answer is ``answer_str``, else
    the first of ``answers``). Each evaluation after training, or alone
    with ``eval_only``, writes ``vqa_advanced_predictions.json``."""
    from visualbert_torch.data.datasets import vqa as vqa_ds

    tok = _tokenizer(cfg)
    d = cfg.data
    if "synthetic" in d:
        ann, feats, _ = vqa_ds.make_synthetic(int(d["synthetic"]), tok, n_answers=int(d.get("n_answers", 8)),
                                              feat_dim=cfg.model.visual_embedding_dim)
        split = int(len(ann) * 0.8)
        train_ann, eval_ann = ann[:split], ann[split:]
    else:
        train_ann, eval_ann, feats = _json(d["train_annotations"]), _json(d["eval_annotations"]), _features(d)

    def mk(ann):
        return vqa_ds.VQADataset(ann, feats, tok, None, advanced=True,
                                 max_seq_length=int(d.get("max_seq_length", 128)),
                                 max_regions=int(d.get("max_regions", 100)))

    model = VisualBertForTask(cfg.model, head_type="vqa_advanced")
    return _run_fit(cfg, _trainer(cfg, model, device), mk(train_ann), mk(eval_ann),
                    dump_hook=vqa_advanced_dump_hook(tok), val_metric="mlm_accuracy",
                    out_select=vqa_advanced_select)


def vqa_advanced_select(out):
    """The argmax of the [B, P, V] logits on their device (JAX
    ``registry.py:332-336``): ``pred_ids`` [B, P] in place of ``logits``."""
    out = dict(out)
    out["pred_ids"] = out.pop("logits").argmax(dim=-1)
    return out


def vqa_advanced_dump_hook(tokenizer):
    """The dump hook of ``vqa_advanced`` (JAX ``registry.py:338-361``):
    ``vqa_advanced_predictions.json``, [{"question_id", "answer"}], the
    answer the predicted wordpieces at the slots whose label is not -1,
    joined with their ``##`` continuations. The repeated tail rows of the
    last eval batch are not questions and are left out (the JAX hook
    writes them too)."""
    inv_vocab = {v: k for k, v in tokenizer.vocab.items()}

    def dump(collected, folder):
        preds = []
        for batch, out in collected:
            labels, positions = np.asarray(batch["masked_lm_labels"]), np.asarray(batch["mlm_positions"])
            for b in range(int(batch.get("_real_count", len(out["pred_ids"])))):
                slots = np.flatnonzero(labels[b][positions[b]] != -1)
                toks = [inv_vocab.get(int(out["pred_ids"][b, j]), "[UNK]") for j in slots]
                preds.append({"question_id": int(batch["question_id"][b]),
                              "answer": " ".join(toks).replace(" ##", "")})
        with open(os.path.join(folder, "vqa_advanced_predictions.json"), "w") as f:
            json.dump(preds, f)
        return {}

    return dump


@register("nlvr2")
def run_nlvr2(cfg: TaskConfig, device):
    """NLVR2 fine-tuning with the 2-way ``nlvr`` head. Synthetic data is
    split 80/20 into train and eval. Real data: ``train_annotations`` and
    ``eval_annotations`` (JSON lines, one example a line), ``features_h5``
    and ``vocab_file``. Each evaluation after training, or alone with
    ``eval_only``, writes ``nlvr2_report.csv`` and returns the official
    accuracy and consistency."""
    from visualbert_torch.data.datasets import nlvr2 as nlvr_ds
    from visualbert_torch.data.features import H5Features

    tok = _tokenizer(cfg)
    d = cfg.data
    if "synthetic" in d:
        ann, feats = nlvr_ds.make_synthetic(int(d["synthetic"]), tok, feat_dim=cfg.model.visual_embedding_dim)
        split = int(len(ann) * 0.8)
        train_ann, eval_ann = ann[:split], ann[split:]
    else:
        def read_jsonl(path):
            with open(path) as f:
                return [json.loads(line) for line in f if line.strip()]

        train_ann, eval_ann = read_jsonl(d["train_annotations"]), read_jsonl(d["eval_annotations"])
        feats = H5Features(d["features_h5"])

    def mk(ann):
        return nlvr_ds.NLVR2Dataset(ann, feats, tok, max_seq_length=int(d.get("max_seq_length", 128)),
                                    max_regions_per_image=int(d.get("max_regions_per_image", 72)))

    model = VisualBertForTask(cfg.model, head_type="nlvr")
    return _run_fit(cfg, _trainer(cfg, model, device), mk(train_ann), mk(eval_ann),
                    dump_hook=nlvr2_dump_hook(eval_ann))


def nlvr2_dump_hook(eval_ann):
    """The dump hook of ``nlvr2`` (JAX ``registry.py:496-515``):
    ``nlvr2_report.csv``, one row an identifier, recovered through the
    batches' ``example_index`` (the tail-pad repeats of the last batch
    collapse in the dict), and the official accuracy and consistency when
    the split has labels."""
    from visualbert_torch.utils.nlvr2_eval import accuracy, consistency, write_csv_report

    eval_ids = [a["identifier"] for a in eval_ann]
    labels = {a["identifier"]: int(a["label"]) for a in eval_ann if "label" in a}

    def dump(collected, folder):
        preds = {}
        for batch, out in collected:
            for i, p in zip(np.asarray(batch["example_index"]), np.asarray(out["logits"]).argmax(-1)):
                preds[eval_ids[int(i)]] = int(p)
        write_csv_report(os.path.join(folder, "nlvr2_report.csv"), sorted(preds.items()))
        if labels:
            return {"official_accuracy": accuracy(preds, labels), "consistency": consistency(preds, labels)}
        return {}

    return dump


def _flickr_dataset(cfg: TaskConfig, ann, feats, tok):
    from visualbert_torch.data.datasets import flickr as flickr_ds

    d = cfg.data
    return flickr_ds.Flickr30kDataset(ann, feats, tok, max_seq_length=int(d.get("max_seq_length", 128)),
                                      max_regions=int(d.get("max_regions", 100)),
                                      max_entities=int(d.get("max_entities", 16)))


def _flickr_synthetic(cfg: TaskConfig, tok):
    """(annotations, features) of a synthetic Flickr30k set."""
    from visualbert_torch.data.datasets import flickr as flickr_ds

    return flickr_ds.make_synthetic(int(cfg.data["synthetic"]), tok, feat_dim=cfg.model.visual_embedding_dim)


@register("flickr")
def run_flickr(cfg: TaskConfig, device):
    """Flickr30k Entities grounding with the ``flickr`` head. Synthetic data
    is split 80/20 into train and eval; real data: ``train_annotations`` and
    ``eval_annotations`` (json lists), ``features_h5`` and ``vocab_file``.
    Each evaluation after training, or alone with ``eval_only``, adds the
    R@1/5/10 of :func:`flickr_dump_hook` to the metrics."""
    from visualbert_torch.data.features import H5Features

    tok = _tokenizer(cfg)
    d = cfg.data
    if "synthetic" in d:
        ann, feats = _flickr_synthetic(cfg, tok)
        split = int(len(ann) * 0.8)
        train_ann, eval_ann = ann[:split], ann[split:]
    else:
        train_ann, eval_ann = _json(d["train_annotations"]), _json(d["eval_annotations"])
        feats = H5Features(d["features_h5"])
    model = VisualBertForTask(cfg.model, head_type="flickr")
    return _run_fit(cfg, _trainer(cfg, model, device), _flickr_dataset(cfg, train_ann, feats, tok),
                    _flickr_dataset(cfg, eval_ann, feats, tok), dump_hook=flickr_dump_hook)


def flickr_dump_hook(collected, folder):
    """R@1/5/10 of ``flickr``: the share of real entities whose k best-scored
    regions hold gold mass, the paper's grounding metric (reference
    compute_score_with_logits_flickr, modeling.py:1648-1676; JAX
    ``registry.py:548-563``). The repeated tail rows of the last eval batch
    are left out (the JAX hook counts them)."""
    hits = {1: 0, 5: 0, 10: 0}
    total = 0
    for batch, out in collected:
        n = int(batch.get("_real_count", len(batch["label"])))
        scores = np.asarray(out["logits"][:n], np.float32)  # [n, E, R]
        label = np.asarray(batch["label"][:n], np.float32)
        valid = np.asarray(batch["flickr_position"][:n]) >= 0
        order = np.argsort(-scores, axis=-1)
        for k in hits:
            topk = np.take_along_axis(label, order[..., :k], axis=-1).sum(-1) > 0
            hits[k] += int(topk[valid].sum())
        total += int(valid.sum())
    return {f"recall_at_{k}": hits[k] / max(total, 1) for k in hits}


@register("flickr_probe")
def run_flickr_probe(cfg: TaskConfig, device):
    """Attention probing (ACL 2020 "What Does BERT with Vision Look At?";
    JAX ``registry.py:568-657``): restore a ``flickr`` checkpoint
    (``--restore``), run the Flickr30k eval split once with the encoder's
    attention probabilities collected (the einsum attention, whatever the
    config's ``use_flash_attention``), gather each entity's attention over
    the regions on the device and count, layer by layer, the entities whose
    most-attended region (mean over heads) holds gold mass. The whole
    synthetic set is the split; real data: ``eval_annotations``,
    ``features_h5`` and ``vocab_file``. Writes
    ``<folder>/flickr_probe.json`` = {"entities": n, "layer_0": acc, ...};
    the task's metric is the best layer's accuracy."""
    from visualbert_torch.data.features import H5Features
    from visualbert_torch.tasks.probing import entity_region_attention, grounding_counts_from_era

    tok = _tokenizer(cfg)
    if "synthetic" in cfg.data:
        ann, feats = _flickr_synthetic(cfg, tok)
    else:
        ann, feats = _json(cfg.data["eval_annotations"]), H5Features(cfg.data["features_h5"])
    ds = _flickr_dataset(cfg, ann, feats, tok)
    trainer = _trainer(cfg, VisualBertForTask(cfg.model, head_type="flickr"), device)
    trainer.init_state()
    if cfg.restore_checkpoint:
        _restore(cfg, trainer)
    eval_b = Batcher(ds, cfg.train.eval_batch_size, shuffle=False, seed=cfg.train.seed, drop_last=False,
                     pad_final=True, num_workers=cfg.train.num_workers, process_shard=_process_shard(trainer))
    hits, total = None, 0
    try:
        for batch in eval_b.epoch(0):
            probs = trainer.eval_step(batch, output_attention_probs=True)["attention_weights"]
            era = entity_region_attention(probs, torch.as_tensor(batch["flickr_position"]), ds.max_seq_length,
                                          ds.max_regions).cpu().numpy()
            del probs
            h, t = grounding_counts_from_era(era, batch["flickr_position"], batch["label"],
                                             row_mask=batch["example_weight"] > 0)
            hits = h if hits is None else hits + h
            total += t
    finally:
        eval_b.close()
    # the split's counts: every data rank's hits and entities summed
    counts = all_reduce_numbers(np.append(hits, total), trainer.data_group, trainer.device)
    hits, total = counts[:-1].astype(np.int64), int(counts[-1])
    accs = {f"layer_{layer}": float(hits[layer]) / max(total, 1) for layer in range(len(hits))}
    path = os.path.join(cfg.folder, "flickr_probe.json")
    if distributed.rank() == 0:
        with open(path, "w") as f:
            json.dump({"entities": total, **accs}, f, indent=1)
    log.info("flickr_probe over %d entities -> %s: %s", total, path, {k: round(v, 4) for k, v in accs.items()})
    return trainer, FitResult(best_metric=max(accs.values()), best_epoch=-1, epochs_run=0, history=[accs])


def _symbolic_vocab(d):
    """The BUTD object and attribute vocabularies (``objects_vocab``,
    ``attributes_vocab``), or the synthetic sets' 32 + 8 classes."""
    from visualbert_torch.data.symbolic import SymbolicVocab

    if "objects_vocab" in d:
        return SymbolicVocab.from_files(d["objects_vocab"], d["attributes_vocab"])
    return SymbolicVocab([f"obj{i}" for i in range(32)], [f"attr{i}" for i in range(8)])


@register("text_pretrain")
def run_text_pretrain(cfg: TaskConfig, device):
    """Text-only MLM pretraining over a packed corpus (the reference's
    BERTDataset path, fine_tuning.py:47-270, on ``PackedCorpus`` with
    whole-word masking; JAX ``registry.py:858-883``): the ``pretraining``
    head with no visual stream, its fused cross-entropy over every text
    row. Real data: ``text_corpus`` (a ``PackedCorpus.save`` file) and
    ``vocab_file``; the synthetic corpus repeats one word a passage. No eval
    split; the pooler trains. The model holds the visual embeddings, which
    text batches never reach (the JAX tree, built from a text batch, has
    none)."""
    from visualbert_torch.data.text_corpus import PackedCorpus, TextOnlyDataset

    tok = _tokenizer(cfg)
    d = cfg.data
    if "synthetic" in d:
        words = [w for w in tok.vocab if not w.startswith("[")]
        rng = np.random.default_rng(0)
        passages = []
        for _ in range(int(d["synthetic"])):
            w = words[int(rng.integers(len(words)))]
            passages.append([" ".join([w] * 8) for _ in range(2)])
        corpus = PackedCorpus.build(passages, tok)
    else:
        corpus = PackedCorpus.load(d["text_corpus"])
    ds = TextOnlyDataset(corpus, tok, max_seq_length=int(d.get("max_seq_length", 64)))
    model = VisualBertForTask(cfg.model, head_type="pretraining")
    return _run_fit(cfg, _trainer(cfg, model, device), ds, None, val_metric="loss")


@register("unsup_pretrain")
def run_unsup_pretrain(cfg: TaskConfig, device):
    """Unsupervised V&L pretraining (NAACL 2021; JAX ``registry.py:717-855``,
    reference lxmert_pretrain.py): ``UnsupervisedVisualBert`` over a hybrid
    of sources, each batch from one (``HybridBatcher``): the V&L set, an
    image-only view of it with ``image_only_ratio`` (or of
    ``image_only_annotations``) and a ``text_corpus`` (a ``PackedCorpus``
    file, ``text_seq_length`` tokens, ``text_ratio``). ``task_qa`` adds the
    QA head, its string answers mapped through ``answer_table``. An eval
    split (``val_synthetic`` or ``val_annotations``) gives each epoch's val
    loss, and the best checkpoint is the lowest; the pooler trains.
    Synthetic data has ``n_regions`` regions an image (the JAX task builds
    its 6-region set whatever ``n_regions`` says, and fails unless it is 6).
    Real data: ``annotations`` (a json list of {"image_id", "sentence"[,
    "ans"]}), ``features_h5``, ``vocab_file`` and the BUTD
    ``objects_vocab`` / ``attributes_vocab``. ``--restore`` resumes;
    ``--eval_only`` evaluates the eval split."""
    from visualbert_torch.data.datasets import unsup_pretrain as up
    from visualbert_torch.data.hybrid import HybridBatcher
    from visualbert_torch.data.text_corpus import PackedCorpus, TextOnlyDataset
    from visualbert_torch.models.unsupervised import UnsupervisedConfig, UnsupervisedVisualBert

    tok = _tokenizer(cfg)
    d = cfg.data
    sym = _symbolic_vocab(d)
    # the QA co-training answers arrive as strings and map through the
    # normalised AnswerTable, unmapped to -1 (lxmert_data.py:105-141)
    answer_table = None
    num_answers = int(d.get("num_answers", 9500))
    if d.get("answer_table"):
        from visualbert_torch.data.answer_table import AnswerTable

        answer_table = AnswerTable.from_json(d["answer_table"])
        num_answers = len(answer_table)
    ucfg = UnsupervisedConfig(bert=cfg.model, visual_feat_dim=cfg.model.visual_embedding_dim, obj_id_num=sym.n_obj,
                              attr_id_num=sym.n_attr, symbolic_vocab_size=sym.size,
                              task_qa=bool(d.get("task_qa", False)), num_answers=num_answers)
    n_regions = int(d.get("n_regions", 36))
    if "synthetic" in d:
        ann, feats = up.make_synthetic(int(d["synthetic"]), tok, sym, n_regions=n_regions,
                                       feat_dim=cfg.model.visual_embedding_dim,
                                       answers=int(d.get("synthetic_answers", 0)))
    else:
        from visualbert_torch.data.features import H5Features

        ann, feats = _json(d["annotations"]), H5Features(d["features_h5"])
    if answer_table is not None:
        for item in ann:
            a = item.get("ans")
            if isinstance(a, str):
                mapped = answer_table.ans_to_id(a)
                item["ans"] = -1 if mapped is None else int(mapped)
    elif ucfg.task_qa and any(isinstance(it.get("ans"), str) for it in ann):
        # without a table every string answer would be ignored and QA
        # co-training silently a no-op
        raise ValueError("task_qa is on and the annotations carry string answers, but no data.answer_table is "
                         "configured: every answer would map to -1 (ignored)")

    ds_kw = dict(max_seq_length=int(d.get("max_seq_length", 30)), n_regions=n_regions)
    workers, seed = cfg.train.num_workers, cfg.train.seed
    trainer = _trainer(cfg, UnsupervisedVisualBert(ucfg), device).init_state()
    shard = _process_shard(trainer)
    vl = up.UnsupervisedPretrainDataset(ann, feats, tok, sym, matched_prob=float(d.get("matched_prob", 0.5)), **ds_kw)
    sources = [Batcher(vl, cfg.train.train_batch_size, seed=seed, num_workers=workers, process_shard=shard)]
    ratios = [1.0]
    if d.get("image_only_ratio"):
        # the V&L entries without their text (reference image_only_splits,
        # lxmert_pretrain.py:126-139)
        img_ann = ann
        if "image_only_annotations" in d:
            img_ann = _json(d["image_only_annotations"])
        img_only = up.UnsupervisedPretrainDataset(img_ann, feats, tok, sym, image_only=True, **ds_kw)
        sources.append(Batcher(img_only, cfg.train.train_batch_size, seed=seed + 1, num_workers=workers,
                               process_shard=shard))
        ratios.append(float(d["image_only_ratio"]))
    if "text_corpus" in d:
        txt = TextOnlyDataset(PackedCorpus.load(d["text_corpus"]), tok,
                              max_seq_length=int(d.get("text_seq_length", 64)),
                              matched_objective=bool(d.get("text_matched_objective", False)))
        sources.append(Batcher(txt, cfg.train.train_batch_size, seed=seed, num_workers=workers, process_shard=shard))
        ratios.append(float(d.get("text_ratio", 1.0)))
    hybrid = HybridBatcher(sources, ratios, seed=seed)

    # the eval split: each epoch's val loss and the best checkpoint (the
    # reference's BEST_EVAL_LOSS loop, lxmert_pretrain.py:379-412)
    val_b = None
    if "val_annotations" in d or d.get("val_synthetic"):
        if "val_annotations" in d:
            val_ann, val_feats = _json(d["val_annotations"]), feats
        else:
            val_ann, val_feats = up.make_synthetic(int(d["val_synthetic"]), tok, sym, n_regions=n_regions,
                                                   feat_dim=cfg.model.visual_embedding_dim, seed=1)
        val = up.UnsupervisedPretrainDataset(val_ann, val_feats, tok, sym,
                                             matched_prob=float(d.get("matched_prob", 0.5)), **ds_kw)
        val_b = Batcher(val, cfg.train.eval_batch_size, seed=seed, num_workers=workers, process_shard=shard)

    if cfg.restore_checkpoint:
        _restore(cfg, trainer)
    try:
        if cfg.eval_only:
            if val_b is None:
                raise ValueError("eval_only needs an eval split: set data.val_synthetic or data.val_annotations")
            metrics = evaluate(trainer, val_b, None, cfg.folder)
            return trainer, FitResult(best_metric=metrics.get("loss", float("nan")), best_epoch=-1, epochs_run=0,
                                      history=[metrics])
        result = fit(trainer, lambda e: prefetch(hybrid.epoch(e)),
                     (lambda: prefetch(val_b.epoch(0))) if val_b is not None else None,
                     checkpoint_dir=os.path.join(cfg.folder, "ckpt"), val_metric="loss",
                     val_metric_higher_is_better=False)
    finally:
        hybrid.close()
        if val_b is not None:
            val_b.close()
    return trainer, result


@register("unsup_vqa")
def run_unsup_vqa(cfg: TaskConfig, device):
    """VQA fine-tuning of the unsupervised stack (JAX ``registry.py:885-931``;
    reference tasks/vqa.py): ``UnsupervisedVQAModel``, BCE x answers against
    soft scores, the best epoch the one of the highest accuracy. Synthetic
    data (``n_regions`` regions an image, as ``unsup_pretrain``'s) is split
    80/20; real data: ``train_annotations`` and ``eval_annotations`` (json
    lists of {"question_id", "image_id", "sent"[, "label"]}),
    ``features_h5``, ``answer_list`` (a json list), ``vocab_file`` and the
    BUTD vocabularies."""
    from visualbert_torch.data.datasets import unsup_vqa as uv
    from visualbert_torch.models.unsupervised import UnsupervisedConfig, UnsupervisedVQAModel

    tok = _tokenizer(cfg)
    d = cfg.data
    sym = _symbolic_vocab(d)
    n_regions = int(d.get("n_regions", 36))
    if "synthetic" in d:
        ann, feats, answers = uv.make_synthetic(int(d["synthetic"]), tok, sym, n_answers=int(d.get("n_answers", 8)),
                                                n_regions=n_regions, feat_dim=cfg.model.visual_embedding_dim)
        split = int(len(ann) * 0.8)
        train_ann, eval_ann = ann[:split], ann[split:]
    else:
        from visualbert_torch.data.features import H5Features

        train_ann, eval_ann = _json(d["train_annotations"]), _json(d["eval_annotations"])
        feats, answers = H5Features(d["features_h5"]), _json(d["answer_list"])
    ucfg = UnsupervisedConfig(bert=cfg.model, visual_feat_dim=cfg.model.visual_embedding_dim, obj_id_num=sym.n_obj,
                              attr_id_num=sym.n_attr, symbolic_vocab_size=sym.size, num_answers=len(answers))

    def mk(a):
        return uv.UnsupVQADataset(a, feats, tok, sym, answers, max_seq_length=int(d.get("max_seq_length", 20)),
                                  n_regions=n_regions)

    return _run_fit(cfg, _trainer(cfg, UnsupervisedVQAModel(ucfg), device), mk(train_ann), mk(eval_ann))


def run(cfg: TaskConfig, device):
    """Run ``cfg.task`` on ``device``; returns (trainer, FitResult). Logs are
    teed into ``run_N.log`` in the run folder."""
    if cfg.task not in TASKS:
        raise KeyError(f"unknown task {cfg.task}; known: {sorted(TASKS)}")
    device = distributed.rank_device(device)
    handler = add_run_folder(cfg.folder) if distributed.rank() == 0 else None
    try:
        log.info("running task %s on %s -> %s", cfg.task, device, cfg.folder)
        return TASKS[cfg.task](cfg, device)
    finally:
        if handler is not None:
            get_logger().removeHandler(handler)
            handler.close()
