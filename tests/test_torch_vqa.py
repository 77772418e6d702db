"""VQA fine-tuning in the port (data/datasets/vqa.py, the ``vqa`` head,
tasks/registry.py's ``run_vqa``, ``evaluate`` and ``--eval_only``) against
the JAX package, on the CPU.

Batches are byte-identical to the JAX dataset's. The head's logits, loss,
accuracy and every parameter gradient agree with the JAX model on exported
weights in fp32 with dropout off (atol 2e-5 / rtol 1e-4, the bar the JAX
encoder meets against HF), and so do ``evaluate``'s metrics. The port's
prediction file holds one entry per eval question; the JAX hook also writes
the repeated tail rows of the last batch, so the port's file is held equal
to the JAX file's first entries.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import OptimizerConfig as JaxOptConfig
from visualbert_tpu.config import TrainConfig as JaxTrainConfig
from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.data.datasets import vqa as jax_vqa
from visualbert_tpu.data.features import NpyFolderFeatures as JaxNpyFolderFeatures
from visualbert_tpu.data.pipeline import Batcher as JaxBatcher
from visualbert_tpu.data.tokenization import BertTokenizer as JaxTokenizer
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.parallel.mesh import create_mesh
from visualbert_tpu.tasks import registry as jax_registry
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import Trainer as JaxTrainer
from visualbert_tpu.train.trainer import unbox
from visualbert_torch.config import OptimizerConfig, TrainConfig, VisualBertConfig
from visualbert_torch.data.datasets import vqa
from visualbert_torch.data.features import NpyFolderFeatures
from visualbert_torch.data.pipeline import Batcher
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.tasks import registry
from visualbert_torch.tools.weights import load_state
from visualbert_torch.train.trainer import Trainer
from visualbert_torch.utils.config_io import load_task_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VQA_SYNTH = os.path.join(REPO, "configs", "vqa_synth.json")
ATOL, RTOL = 2e-5, 1e-4
WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "?"] + [f"w{i}" for i in range(100)]  # the synthetic vocab
SMALL = dict(vocab_size=len(WORDS), hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_position_embeddings=64, visual_embedding_dim=16)


def tokenizers():
    vocab = {w: i for i, w in enumerate(WORDS)}
    return BertTokenizer(vocab), JaxTokenizer(vocab)


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


def npy_folder_datasets(tmp_path):
    """The same imdb-style annotations, .npy features and answer file read
    by both packages: ragged region counts, answers outside the vocabulary,
    a missing question_id, a question cut at max_seq_length."""
    rng = np.random.RandomState(0)
    answers = ["yes", "no", "two", "red"]
    (tmp_path / "answers.txt").write_text("\n".join(answers) + "\n")
    ann = []
    for i in range(11):
        np.save(tmp_path / f"img{i}.npy", rng.randn(2 + 3 * i, 16).astype(np.float32))
        item = {"question_tokens": [f"w{(i * 7 + k) % 100}" for k in range(3 + 4 * (i % 4))], "image_id": f"img{i}",
                "answers": [answers[(i + k) % 4] for k in range(1 + i % 3)] + ["maybe"]}
        if i != 4:
            item["question_id"] = 100 + i
        ann.append(item)
    (t_ours, t_theirs) = tokenizers()
    kw = dict(max_seq_length=12, max_regions=20)
    ours = vqa.VQADataset(ann, NpyFolderFeatures(str(tmp_path)), t_ours,
                          vqa.AnswerVocab.from_file(str(tmp_path / "answers.txt")), **kw)
    theirs = jax_vqa.VQADataset(ann, JaxNpyFolderFeatures(str(tmp_path)), t_theirs,
                                jax_vqa.AnswerVocab.from_file(str(tmp_path / "answers.txt")), **kw)
    return ours, theirs


def synthetic_datasets(_):
    t_ours, t_theirs = tokenizers()
    ann, feats, vocab = vqa.make_synthetic(40, t_ours, n_answers=8, feat_dim=16)
    ann_j, feats_j, vocab_j = jax_vqa.make_synthetic(40, t_theirs, n_answers=8, feat_dim=16)
    assert ann == ann_j and vocab.word_list == vocab_j.word_list
    for a in ann:
        assert feats.get(a["image_id"])["features"].tobytes() == feats_j.get(a["image_id"])["features"].tobytes()
    return (vqa.VQADataset(ann, feats, t_ours, vocab, max_seq_length=16, max_regions=10),
            jax_vqa.VQADataset(ann_j, feats_j, t_theirs, vocab_j, max_seq_length=16, max_regions=10))


@pytest.mark.parametrize("make", [synthetic_datasets, npy_folder_datasets], ids=["synthetic", "npy_folder"])
def test_vqa_batches_are_byte_identical_to_jax(tmp_path, make):
    ours, theirs = make(tmp_path)
    tail = dict(shuffle=False, drop_last=False, pad_final=True)
    batchers = [Batcher(ours, 4, seed=3, num_workers=2), JaxBatcher(theirs, 4, seed=3, num_workers=2),
                Batcher(ours, 4, **tail), JaxBatcher(theirs, 4, **tail)]
    try:
        for epoch in (0, 1):
            assert_same_batches(batchers[0].epoch(epoch), batchers[1].epoch(epoch))
        assert_same_batches(batchers[2].epoch(0), batchers[3].epoch(0))
    finally:
        for b in batchers:
            b.close()


def head_batch(rng, n_answers):
    B, TT, TV = 3, 10, 6
    input_mask = np.zeros((B, TT), np.int32)
    for i, n in enumerate((10, 6, 4)):  # the gather slot sum(mask) - 2 differs per row
        input_mask[i, :n] = 1
    image_mask = np.ones((B, TV), np.int32)
    image_mask[2, -2:] = 0
    label = np.zeros((B, n_answers), np.float32)
    label[0, [0, 3]] = [1.0, 0.3]  # mass on class 0, which the accuracy zeroes
    label[1, 1:] = 0.3  # any argmax but class 0 scores here
    label[1, 2] = 0.9
    label[2, [1, 5]] = [0.6, 0.3]
    return {
        "input_ids": rng.randint(0, SMALL["vocab_size"], (B, TT)).astype(np.int32),
        "token_type_ids": np.zeros((B, TT), np.int32),
        "input_mask": input_mask,
        "visual_embeddings": rng.randn(B, TV, SMALL["visual_embedding_dim"]).astype(np.float32),
        "image_mask": image_mask,
        "label": label,
        "example_weight": np.array([1.0, 1.0, 0.0], np.float32),  # a tail-pad duplicate
    }


def to_torch(batch):
    return {k: torch.tensor(v).long() if v.dtype.kind == "i" else torch.tensor(v) for k, v in batch.items()}


@pytest.mark.parametrize("kernels", [False, True], ids=["einsum", "flash_fused_ln"])
def test_vqa_head_matches_jax(rng, kernels):
    kw = dict(use_flash_attention=kernels, use_fused_layer_norm=kernels)
    jcfg, tcfg = JaxConfig(**SMALL, dtype=jnp.float32, **kw), VisualBertConfig(**SMALL, dtype=torch.float32, **kw)
    batch = head_batch(rng, 7)
    jm = JaxTask(jcfg, head_type="vqa", num_answers=7)
    params = unbox(jm.init(jax.random.PRNGKey(2), batch)["params"])
    jbatch = jax.tree.map(jnp.asarray, batch)

    def loss_fn(p):
        out = jm.apply({"params": p}, jbatch, deterministic=True)
        return out["loss"], out

    (_, out_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    model = load_state(VisualBertForTask(tcfg, "vqa", num_answers=7), export_state_dict(params, jcfg))
    out_t = model(to_torch(batch))
    out_t["loss"].backward()
    np.testing.assert_allclose(out_t["logits"].detach().numpy(), out_j["logits"], atol=ATOL, rtol=RTOL)
    for k in ("loss", "accuracy"):
        np.testing.assert_allclose(float(out_t[k].detach()), float(out_j[k]), atol=ATOL, rtol=RTOL)
    assert float(out_j["accuracy"]) > 0  # the weighted rows score, the zero-weight one does not count
    want = export_state_dict(grads_j, jcfg)
    names = dict(model.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        # the pooler takes no part in the vqa head: no gradient, zeros in JAX
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(want[name])
        assert p.grad is not None or name.startswith("bert.pooler."), name
        np.testing.assert_allclose(got, want[name], atol=ATOL, rtol=RTOL, err_msg=name)


def jax_dump_hook(vocab):
    """The JAX ``run_vqa`` dump hook (visualbert_tpu/tasks/registry.py:280-289)."""

    def dump(collected, folder):
        qids, logits = [], []
        for batch, out in collected:
            qids.extend(int(q) for q in batch["question_id"])
            logits.append(np.asarray(out["logits"], np.float32))
        jax_vqa.VQAEvaluator(vocab).dump(qids, np.concatenate(logits), os.path.join(folder, "vqa_predictions.json"))
        return {}

    return dump


def test_evaluate_matches_jax_evaluate(tmp_path):
    t_ours, t_theirs = tokenizers()
    ann, feats, _ = vqa.make_synthetic(20, t_ours, n_answers=6, feat_dim=16)
    vocab = vqa.AnswerVocab([f"a{i}" for i in range(6)])
    for a in ann:  # answers in the test's vocabulary
        a["answers"] = [f"a{a['question_id'] % 6}"] * 3
    jax_vocab = jax_vqa.AnswerVocab(vocab.word_list)
    ours = vqa.VQADataset(ann, feats, t_ours, vocab, max_seq_length=12, max_regions=10)
    theirs = jax_vqa.VQADataset(ann, feats, t_theirs, jax_vocab, max_seq_length=12, max_regions=10)
    tail = dict(shuffle=False, drop_last=False, pad_final=True)
    eval_b, jax_eval_b = Batcher(ours, 8, **tail), JaxBatcher(theirs, 8, **tail)  # 8 + 8 + 4 real rows

    jcfg = JaxConfig(**SMALL, dtype=jnp.float32, use_flash_attention=True)
    jtrainer = JaxTrainer(JaxTask(jcfg, head_type="vqa", num_answers=6), JaxOptConfig(), JaxTrainConfig(),
                          create_mesh((1, 1), devices=jax.devices()[:1]))
    state = jtrainer.init_state(jax.random.PRNGKey(0), next(iter(jax_eval_b.epoch(0))))
    (tmp_path / "jax").mkdir()
    want = jax_registry.evaluate(jtrainer, state, jax_eval_b, jax_dump_hook(jax_vocab), str(tmp_path / "jax"))

    tcfg = VisualBertConfig(**SMALL, dtype=torch.float32, use_flash_attention=True)
    model = load_state(VisualBertForTask(tcfg, "vqa", num_answers=6),
                       export_state_dict(jax.device_get(state.params), jcfg))
    trainer = Trainer(model, OptimizerConfig(), TrainConfig(), device="cpu").init_state(init_weights=False)
    (tmp_path / "torch").mkdir()
    got = registry.evaluate(trainer, eval_b, registry.vqa_dump_hook(vocab), str(tmp_path / "torch"))
    assert set(got) == set(want) == {"loss", "accuracy"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL, err_msg=k)
    ours_pred = json.loads((tmp_path / "torch" / "vqa_predictions.json").read_text())
    jax_pred = json.loads((tmp_path / "jax" / "vqa_predictions.json").read_text())
    assert [p["question_id"] for p in ours_pred] == list(range(20))
    assert len(jax_pred) == 24 and ours_pred == jax_pred[:20]


def run_cli(config, folder, *extra):
    from visualbert_torch.train_cli import main

    return main(["--config", str(config), "--folder", str(folder), "--device", "cpu", *extra])


def test_cli_trains_vqa_and_eval_only_reproduces_it(tmp_path, capsys):
    """configs/vqa_synth.json as shipped: 102 training and 26 eval questions,
    batch 16, 10 epochs. The run writes ckpt/ and vqa_predictions.json;
    ``--eval_only --restore`` of its checkpoint gives the last epoch's
    eval metrics and the same predictions."""
    trainer, result = run_cli(VQA_SYNTH, tmp_path / "run")
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    last = result.history[-1]
    assert summary["task"] == "vqa" and summary["epochs_run"] == 10 and trainer.step == 60
    assert summary["best_metric"] == max(h["val_accuracy"] for h in result.history)
    assert np.isfinite(last["train_loss"]) and last["val_accuracy"] > 0.5  # chance is 1/8
    assert (tmp_path / "run" / "ckpt" / "step_60.pt").exists()
    preds = json.loads((tmp_path / "run" / "vqa_predictions.json").read_text())
    assert [p["question_id"] for p in preds] == list(range(102, 128))

    _, again = run_cli(VQA_SYNTH, tmp_path / "eval", "--eval_only", "--restore", str(tmp_path / "run" / "ckpt"))
    assert again.epochs_run == 0 and again.best_metric == pytest.approx(last["val_accuracy"], abs=1e-6)
    for k in ("loss", "accuracy"):
        assert again.history[0][k] == pytest.approx(last["val_" + k], abs=1e-6)
    assert json.loads((tmp_path / "eval" / "vqa_predictions.json").read_text()) == preds


def test_eval_only_needs_an_eval_split(tmp_path):
    """coco_pretrain has no eval split: --eval_only raises, as the JAX
    package asserts (visualbert_tpu/tasks/registry.py:125)."""
    config = tmp_path / "coco.json"
    config.write_text(json.dumps({
        "task": "coco_pretrain", "data": {"synthetic": 8, "max_seq_length": 16, "max_regions": 10},
        "model": dict(SMALL, visual_embedding_dim=32), "train": {"train_batch_size": 4},
    }))
    with pytest.raises(ValueError, match="eval split"):
        run_cli(config, tmp_path / "run", "--eval_only")


def test_vqa_with_stock_dropout_repeats_from_its_seed(tmp_path):
    """fast_dropout off, dropout 0.1: every mask (hidden states, attention
    probabilities, the classifier) comes from the trainer's generator, so
    two runs from one seed give equal losses and another seed others."""
    base = load_task_config(VQA_SYNTH)
    model = base.model.replace(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    assert not model.fast_dropout
    runs = []
    for i, seed in enumerate((3, 3, 4)):
        cfg = dataclasses.replace(base, model=model, folder=str(tmp_path / f"run{i}"),
                                  train=dataclasses.replace(base.train, num_train_epochs=1, seed=seed))
        torch.manual_seed(i)  # the global generator plays no part
        _, result = registry.run(cfg, "cpu")
        runs.append((result.history[0]["train_loss"], result.history[0]["val_loss"]))
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[2][0]
