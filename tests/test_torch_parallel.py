"""visualbert_torch's (data, model) mesh on the CPU: gloo ranks, each a
process started by ``tests/torch_dist_worker.py`` (file-store rendezvous,
no port; every launch has a timeout), against the JAX package on the
conftest's virtual devices and against the port's own one-process runs.

A mesh does not change JAX's math, so any JAX mesh is a witness; the JAX
side runs on ``create_mesh(shape, devices=jax.devices()[:d * m])``, in the
test process while the port's ranks run (:func:`launch_beside`). The
port's ranks start from JAX's exported weights. Tiny model, fp32, dropout
off unless said; fp32 atol 2e-5 / rtol 1e-4. The batches give the data
ranks different labelled counts and put a zero-weight tail row on the last
rank, so averaging the ranks' own means instead of dividing by the global
count would show.
"""

import json
import os
import socket
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import OptimizerConfig as JaxOptConfig
from visualbert_tpu.config import TrainConfig as JaxTrainConfig
from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.data.pipeline import Batcher as JaxBatcher
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.parallel import distributed as jax_distributed
from visualbert_tpu.parallel.mesh import create_mesh as jax_create_mesh
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import Trainer as JaxTrainer
from visualbert_torch.config import OptimizerConfig, TrainConfig, VisualBertConfig
from visualbert_torch.data.pipeline import Batcher
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.ops.mlm_xent import mlm_xent
from visualbert_torch.parallel.mesh import create_mesh, model_split_dim
from visualbert_torch.tools.weights import load_state
from visualbert_torch.train.optimizer import BertAdam
from visualbert_torch.train.trainer import Trainer
from visualbert_torch.utils.checkpoint import CheckpointManager

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_worker import build_model, launch  # noqa: E402

ATOL, RTOL = 2e-5, 1e-4
# the vocabulary splits over JAX's model axis, so it is even
SMALL = dict(vocab_size=96, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_position_embeddings=64, visual_embedding_dim=24,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
KERNELS = dict(use_flash_attention=True, use_fused_layer_norm=True, fast_dropout=True)
OPT = dict(learning_rate=1e-3, schedule="warmup_linear", warmup=0.3, t_total=6, frozen=("pooler",))
B, TT, TV, P, N_ANSWERS = 4, 11, 8, 3, 5
STEPS = 3


def pretrain_batches(n, seed=0):
    """Rows 0-1 (data rank 0 of 2) carry 1 MLM label each, rows 2-3 three;
    row 3 is a zero-weight tail duplicate (its labels drop out)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        lm = np.full((B, TT), -1, np.int32)
        pos = np.zeros((B, P), np.int32)
        for i in range(B):
            p = np.sort(rng.choice(np.arange(1, TT), size=P, replace=False))
            pos[i] = p
            k = 1 if i < 2 else P
            lm[i, p[:k]] = rng.randint(0, SMALL["vocab_size"], size=k)
        input_mask = np.ones((B, TT), np.int32)
        input_mask[0, -2:] = 0
        out.append({
            "input_ids": rng.randint(0, SMALL["vocab_size"], (B, TT)).astype(np.int32),
            "token_type_ids": np.zeros((B, TT), np.int32),
            "input_mask": input_mask,
            "visual_embeddings": rng.randn(B, TV, SMALL["visual_embedding_dim"]).astype(np.float32),
            "image_mask": np.ones((B, TV), np.int32),
            "masked_lm_labels": lm,
            "mlm_positions": pos,
            "is_random_next": np.array([0, -1, 1, 0], np.int32),
            "example_weight": np.array([1, 1, 1, 0], np.float32),
        })
    return out


def vqa_batches(n, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        input_mask = np.zeros((B, TT), np.int32)
        for i, k in enumerate((11, 7, 5, 9)):
            input_mask[i, :k] = 1
        label = (rng.rand(B, N_ANSWERS) * (rng.rand(B, N_ANSWERS) > 0.5)).astype(np.float32)
        out.append({
            "input_ids": rng.randint(0, SMALL["vocab_size"], (B, TT)).astype(np.int32),
            "token_type_ids": np.zeros((B, TT), np.int32),
            "input_mask": input_mask,
            "visual_embeddings": rng.randn(B, TV, SMALL["visual_embedding_dim"]).astype(np.float32),
            "image_mask": np.ones((B, TV), np.int32),
            "label": label,
            "example_weight": np.array([1, 1, 1, 0], np.float32),
        })
    return out


class JaxRun:
    """The JAX Trainer of ``make_model(mesh)`` on a (d, m) mesh of the first
    d * m devices, ``accum`` microbatches a step (a batch's rows in order):
    its initial weights in the port's names (``export`` of the Flax params)
    at once, every step's metrics and the final weights from :meth:`train`.
    With ``like`` (a run of a model with the same parameter tree on the
    same mesh) it starts from a copy of that run's initial state instead of
    its own init."""

    def __init__(self, make_model, shape, batches, export, accum=1, like=None):
        mesh = jax_create_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])
        self.trainer = JaxTrainer(make_model(mesh), JaxOptConfig(**OPT),
                                  JaxTrainConfig(gradient_accumulation_steps=accum), mesh)
        if like is None:
            self.state = self.trainer.init_state(jax.random.PRNGKey(0), batches[0])
        else:
            self.trainer._specs = like.trainer._specs
            self.state = jax.tree.map(jnp.copy, like.state)
        self.batches, self.export, self.accum = batches, export, accum
        self.start = export(jax.device_get(self.state.params))

    def train(self):
        step = self.trainer.train_step_fn()
        state, metrics = self.state, []
        for b in self.batches:
            if self.accum > 1:
                b = {k: v.reshape((self.accum, -1) + v.shape[1:]) for k, v in b.items()}
            state, m = step(state, self.trainer.shard_batch(b, stacked=self.accum > 1), jax.random.PRNGKey(1))
            metrics.append({k: float(v) for k, v in m.items()})
        return self.start, metrics, self.export(jax.device_get(state.params))


def task_run(shape, head_type, batches, flags=None, num_answers=N_ANSWERS, accum=1, like=None):
    """:class:`JaxRun` of VisualBertForTask at SMALL, fp32, with ``flags``
    (their kernels on the mesh)."""
    def config(mesh):
        jcfg = JaxConfig(**SMALL, dtype=jnp.float32, **(flags or {}))
        return jcfg.replace(mesh=mesh) if flags else jcfg

    return JaxRun(lambda mesh: JaxTask(config(mesh), head_type=head_type, num_answers=num_answers), shape, batches,
                  lambda p: export_state_dict(p, config(None)), accum, like)


def launch_beside(jobs, world, tmp, runs, **kw):
    """The port's ``jobs`` on ``world`` ranks (:func:`launch`) while the
    JAX ``runs`` ({name: JaxRun}) train here; (every rank's results,
    {name: run.train()})."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch, jobs, world, tmp, **kw)
        trained = {name: run.train() for name, run in runs.items()}
        return ranks.result(), trained


def port_run(state, head_type, batches, flags=None, num_answers=N_ANSWERS):
    """The port's one-process Trainer from ``state``: metrics and weights."""
    model = load_state(VisualBertForTask(VisualBertConfig(**SMALL, dtype=torch.float32, **(flags or {})),
                                         head_type, num_answers=num_answers), state)
    trainer = Trainer(model, OptimizerConfig(**OPT), TrainConfig(seed=0), "cpu").init_state(init_weights=False)
    metrics = [{k: float(v) for k, v in trainer.train_step(b).items()} for b in batches]
    return metrics, {k: v.detach().numpy() for k, v in model.named_parameters()}


def one_process(state, head_type, batches, flags=None, accum=1, **build):
    """The port's one-process Trainer (any model of ``build_model``) from
    ``state``: every step's metrics and the final weights."""
    model = build_model(dict(SMALL, dtype=torch.float32, **(flags or {})), head_type, state, N_ANSWERS, **build)
    trainer = Trainer(model, OptimizerConfig(**OPT), TrainConfig(seed=0, gradient_accumulation_steps=accum),
                      "cpu").init_state(init_weights=False)
    metrics = []
    for b in batches:
        if accum > 1:
            b = {k: v.reshape((accum, -1) + v.shape[1:]) for k, v in b.items()}
        metrics.append({k: float(v) for k, v in trainer.train_step(b).items()})
    return metrics, {k: v.detach().numpy() for k, v in model.named_parameters()}


def train_job(shape, head_type, state, batches, flags=None, **kw):
    return ("train", dict(mesh_shape=shape, model_cfg=dict(SMALL, dtype=torch.float32, **(flags or {})),
                          head_type=head_type, state=state, batches=batches, opt=OPT, num_answers=N_ANSWERS, **kw))


def assert_metrics(got, want, keys):
    for step, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=RTOL, err_msg=f"step {step} {k}")
    assert len(got) == len(want) == STEPS


def assert_params(got, want):
    assert set(got) <= set(want)
    for k, v in got.items():
        np.testing.assert_allclose(np.asarray(v), want[k], atol=ATOL, rtol=RTOL, err_msg=k)


def assert_ranks_agree(results, job):
    """Every rank reports the same metrics (they are reduced) and gathers
    the same weights."""
    first = results[0][job]
    for r in results[1:]:
        assert r[job]["metrics"] == first["metrics"]
        for k, v in r[job]["params"].items():
            assert torch.equal(v, first["params"][k]), k


MLM_KEYS = ("loss", "masked_lm_loss", "next_sentence_loss", "mlm_accuracy")
VQA_KEYS = ("loss", "accuracy")


# ------------------------------------------------------------- the Batcher


class Counting:
    """Samples whose content names their index and draws from their rng."""

    def __len__(self):
        return 22

    def __getitem__(self, key):
        i, rng = key
        return {"x": np.full(3, i, np.float32) + rng.standard_normal(3).astype(np.float32),
                "i": np.int32(i)}


@pytest.mark.parametrize("mode", ["thread", "process"])
@pytest.mark.parametrize("shard", [(0, 2), (1, 2), (3, 4)])
def test_batcher_process_shard_equals_jax(shard, mode):
    """22 samples in batches of 8 (the last padded from 6 real rows): this
    rank's rows, example_weight and the global _real_count equal the JAX
    Batcher's, and are those rows of the one-process batch."""
    kw = dict(seed=3, drop_last=False, pad_final=True, num_workers=2, worker_mode=mode)
    ours = Batcher(Counting(), 8, process_shard=shard, **kw)
    theirs = JaxBatcher(Counting(), 8, process_shard=shard, **kw)
    whole = Batcher(Counting(), 8, **kw)
    try:
        for epoch in (0, 1):
            got, want, full = list(ours.epoch(epoch)), list(theirs.epoch(epoch)), list(whole.epoch(epoch))
            assert len(got) == len(want) == len(full) == 3
            per = 8 // shard[1]
            rows = slice(shard[0] * per, (shard[0] + 1) * per)
            for g, w, f in zip(got, want, full):
                assert set(g) == set(w)
                for k in ("x", "i", "example_weight"):
                    np.testing.assert_array_equal(g[k], w[k])
                    np.testing.assert_array_equal(g[k], f[k][rows])
                assert g["_real_count"] == w["_real_count"] == f["_real_count"]
            assert got[-1]["_real_count"] == 6.0
    finally:
        for b in (ours, theirs, whole):
            b.close()


@pytest.mark.parametrize("batch,kw", [(6, dict(process_shard=(0, 4))), (8, dict(process_shard=(2, 2))),
                                      (8, dict(drop_last=False, process_shard=(0, 2)))],
                         ids=["uneven", "index", "unpadded_tail"])
def test_batcher_process_shard_refuses_what_jax_refuses(batch, kw):
    """A batch that does not split evenly, an index out of range, a short
    tail that is not padded: JAX's Batcher asserts, the port's raises."""
    with pytest.raises(AssertionError):
        JaxBatcher(Counting(), batch, **kw)
    with pytest.raises(ValueError):
        Batcher(Counting(), batch, **kw)


def test_one_process_mesh_falls_back_as_jax(monkeypatch):
    """One process: (2, 1) falls back to (1, 1) as JAX's create_mesh does on
    one device; local_batch_slice is JAX's."""
    mesh = create_mesh((2, 1))
    assert mesh.shape == tuple(jax_create_mesh((2, 1), devices=jax.devices()[:1]).devices.shape) == (1, 1)
    assert mesh.batch_shard() is None and mesh.data_group is None and mesh.model_group is None
    from visualbert_torch.parallel.distributed import local_batch_slice

    assert local_batch_slice(8) == jax_distributed.local_batch_slice(8) == (0, 8)


# ------------------------------------------------------- multi-rank runs


# a global microbatch under accumulation on (2, 1) is each data rank's i-th
# local row: rows 0 and 2, then 1 and 3
ACCUM_ORDER = [0, 2, 1, 3]


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """(2, 1): the pretraining and VQA heads, gradient accumulation and the
    detector model against JAX's mesh runs and the port's one process, and
    the mesh layout of a fallback."""
    pb, vb = pretrain_batches(STEPS), vqa_batches(STEPS)
    with pytest.MonkeyPatch.context() as mp:
        det = detector_parts(mp)
        runs = {"train": task_run((2, 1), "pretraining", pb), "vqa": task_run((2, 1), "vqa", vb),
                "detector": det["run"]}
        runs["accum"] = task_run((2, 1), "pretraining", [{k: v[ACCUM_ORDER] for k, v in b.items()} for b in pb],
                                 accum=2, like=runs["train"])
        start_p = runs["train"].start
        jobs = [train_job((2, 1), "pretraining", start_p, pb),
                ("vqa", dict(job="train", **train_job((2, 1), "vqa", runs["vqa"].start, vb)[1])),
                ("layout", dict(job="layout", mesh_shape=(4, 1))),
                ("accum", dict(job="train", **train_job((2, 1), "pretraining", start_p, pb, accum=2)[1])),
                ("detector", dict(job="train", **train_job((2, 1), "multichoice", runs["detector"].start,
                                                           det["batches"], kind="detector",
                                                           kind_kw=det["kind_kw"])[1]))]
        results, jax_out = launch_beside(jobs, 2, tmp_path_factory.mktemp("dp"), runs)
    return dict(results=results, pretrain=jax_out["train"] + (pb,), vqa=jax_out["vqa"] + (vb,), jax=jax_out,
                detector=det)


def detector_parts(mp):
    """The VCR detector model (the tiny ResNet50 of the detector tests; the
    JAX detector with its 7 x 7 stem and dropout 0, set through ``mp``, and
    the port's dropout off) and STEPS batches of 2 questions x 4 choices,
    the second question a zero-weight tail row; its JaxRun on (2, 1)."""
    from test_torch_detector import TINY_DET
    from test_torch_vcr import detector_batch, port_state
    from visualbert_tpu.models import detector as jax_det
    from visualbert_tpu.models import vcr as jax_vcr_model

    class Trunk7x7(jax_det.ResNet50Trunk):
        s2d_stem: bool = False

    class NoDropout(jax_det.SimpleDetector):
        dropout_rate: float = 0.0

    mp.setattr(jax_det, "ResNet50Trunk", Trunk7x7)
    mp.setattr(jax_vcr_model, "SimpleDetector", NoDropout)
    kind_kw = dict(final_dim=16, **TINY_DET)
    rng = np.random.RandomState(4)
    batches = [detector_batch(rng) for _ in range(STEPS)]
    for b in batches:
        b["input_ids"] = b["input_ids"] % SMALL["vocab_size"]
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32)
    run = JaxRun(lambda mesh: jax_vcr_model.VisualBertDetectorModel(jcfg, head_type="multichoice", **kind_kw),
                 (2, 1), batches, lambda p: port_state(p, jcfg))
    return dict(kind_kw=kind_kw, batches=batches, run=run)


def test_data_axis_matches_jax_and_one_process(dp_runs):
    """Three steps of the pretraining head on (2, 1), whose data ranks hold
    2 and 5 labels: losses and every parameter equal JAX's mesh run and the
    port's one-process run."""
    results = dp_runs["results"]
    start, want, want_end, batches = dp_runs["pretrain"]
    assert_ranks_agree(results, "train")
    got = results[0]["train"]
    assert_metrics(got["metrics"], want, MLM_KEYS)
    assert_params(got["params"], want_end)
    one, one_end = port_run(start, "pretraining", batches)
    assert_metrics(got["metrics"], one, MLM_KEYS)
    assert_params(got["params"], one_end)


def test_data_axis_weighted_tail_matches_jax(dp_runs):
    """The VQA head (KL divergence and accuracy under example_weight, the
    zero-weight row on rank 1) on (2, 1) equals JAX and one process."""
    results = dp_runs["results"]
    start, want, want_end, batches = dp_runs["vqa"]
    assert_ranks_agree(results, "vqa")
    got = results[0]["vqa"]
    assert_metrics(got["metrics"], want, VQA_KEYS)
    assert_params(got["params"], want_end)
    one, one_end = port_run(start, "vqa", batches)
    assert_metrics(got["metrics"], one, VQA_KEYS)


def test_data_axis_gradient_accumulation(dp_runs):
    """Two microbatches a step on (2, 1): a global microbatch is each data
    rank's i-th local one (rows 0 and 2, then 1 and 3), as in JAX's
    multi-host run; it equals JAX's mesh run and one process accumulating
    over those rows."""
    start, _, _, batches = dp_runs["pretrain"]
    _, want, want_end = dp_runs["jax"]["accum"]
    assert_ranks_agree(dp_runs["results"], "accum")
    got = dp_runs["results"][0]["accum"]
    assert_metrics(got["metrics"], want, MLM_KEYS)
    assert_params(got["params"], want_end)
    one, one_end = one_process(start, "pretraining", [{k: v[ACCUM_ORDER] for k, v in b.items()} for b in batches],
                               accum=2)
    assert_metrics(got["metrics"], one, MLM_KEYS)
    assert_params(got["params"], one_end)


def test_detector_model_on_the_data_axis_equals_one_process(dp_runs):
    """The VCR detector model (ResNet50 trunk, RoIAlign, the multichoice
    head, the detector's masked CE) on (2, 1), one question a rank and the
    zero-weight one on rank 1: losses and every parameter as JAX's mesh run
    and as one process."""
    det = dp_runs["detector"]
    start, want, want_end = dp_runs["jax"]["detector"]
    assert_ranks_agree(dp_runs["results"], "detector")
    got = dp_runs["results"][0]["detector"]
    keys = ("loss", "accuracy", "cnn_regularization_loss")
    assert_metrics(got["metrics"], want, keys)
    assert_params(got["params"], want_end)
    one, one_end = one_process(start, "multichoice", det["batches"], kind="detector", kind_kw=det["kind_kw"])
    assert_metrics(got["metrics"], one, keys)
    assert_params(got["params"], one_end)


def test_multi_rank_layout_and_fallback_equal_jax(dp_runs, monkeypatch):
    """(4, 1) on two ranks falls back to (2, 1), as JAX's create_mesh does on
    two devices; ranks, data slices and Batcher shards follow JAX's
    process-major order and local_batch_slice."""
    assert tuple(jax_create_mesh((4, 1), devices=jax.devices()[:2]).devices.shape) == (2, 1)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for r, res in enumerate(dp_runs["results"]):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        lay = res["layout"]
        assert lay["shape"] == (2, 1) and lay["index"] == (r, 0) and lay["shard"] == (r, 2)
        assert lay["slice"] == jax_distributed.local_batch_slice(8) == (4 * r, 4)
        assert lay["process_shard"] == jax_distributed.process_shard() == (r, 2)


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """(1, 2): the model axis with the kernels' plain versions, the
    cross-entropy under the mesh, its unfused fallback, BertAdam and the
    checkpoints; one launch."""
    tmp = tmp_path_factory.mktemp("tp")
    pb = pretrain_batches(STEPS)
    runs = {"train": task_run((1, 2), "pretraining", pb, KERNELS)}
    runs.update((name, task_run((1, 2), "pretraining", pb, {k: v for k, v in flags.items() if k != "fused_mlm_xent"},
                                like=runs["train"])) for name, flags in TP_PATHS.items())
    start = runs["train"].start
    port_flags = dict(KERNELS, fused_mlm_xent=True)
    # the cross-entropy op on 6 rows, 3 a model rank
    rng = np.random.RandomState(5)
    xent = dict(x=rng.randn(6, 16).astype(np.float32), emb=rng.randn(11, 16).astype(np.float32),
                bias=rng.randn(11).astype(np.float32), labels=np.array([3, -1, 0, 10, 5, -1]),
                g=rng.rand(6).astype(np.float32))
    # 3 rows x 3 slots = 9 MLM rows: no split over 2 model ranks
    odd = {k: torch.tensor(v[:3]).long() if v.dtype.kind == "i" else torch.tensor(v[:3])
           for k, v in pb[0].items()}
    # BertAdam: weights of split and replicated names, big gradients
    names = {n: (8, 8) if n.endswith("weight") else (8,) for n in
             [f"bert.encoder.layer.0.attention.self.{q}.{w}" for q in ("query", "key", "value")
              for w in ("weight", "bias")]
             + ["bert.encoder.layer.0.attention.output.dense.weight", "bert.encoder.layer.0.intermediate.dense.bias",
                "bert.encoder.layer.0.output.dense.weight", "bert.encoder.layer.0.output.LayerNorm.weight"]}
    params = {n: torch.tensor(rng.randn(*s).astype(np.float32)) for n, s in names.items()}
    grads = [{n: torch.tensor((rng.randn(*s) * 5).astype(np.float32)) for n, s in names.items()}
             for _ in range(2)]
    adam_opt = dict(learning_rate=1e-2, schedule="none", weight_decay=0.0, max_grad_norm=1e-3)
    # a checkpoint written by one process, restored at (1, 2), saved again
    ckpt_cfg = dict(SMALL, dtype=torch.float32)
    one = Trainer(load_state(VisualBertForTask(VisualBertConfig(**ckpt_cfg), "pretraining"), start),
                  OptimizerConfig(), TrainConfig(seed=0), "cpu").init_state(init_weights=False)
    written = CheckpointManager(str(tmp / "one")).save(3, one)
    jobs = [train_job((1, 2), "pretraining", start, pb, port_flags),
            ("xent", dict(mesh_shape=(1, 2), **xent)),
            ("unfused", dict(mesh_shape=(1, 2), model_cfg=dict(ckpt_cfg, **port_flags), state=start, batch=odd)),
            ("adam", dict(mesh_shape=(1, 2), params=params, grads=grads, opt=adam_opt)),
            ("checkpoint", dict(mesh_shape=(1, 2), model_cfg=ckpt_cfg, state=None, folder=str(tmp / "tp"),
                                load=written)),
            ("gathered", dict(mesh_shape=(1, 2), model_cfg=ckpt_cfg, state=start))]
    jobs += [(name, dict(job="train", **train_job((1, 2), "pretraining", start, pb, flags)[1]))
             for name, flags in TP_PATHS.items()]
    results, jax_out = launch_beside(jobs, 2, tmp, runs)
    return dict(results=results, jax=jax_out["train"] + (pb,), paths=jax_out, xent=xent, odd=odd,
                adam=(params, grads, adam_opt), one=one, port_flags=port_flags)


# the other attention paths and the eager epilogue under tensor parallelism
# (the JAX witnesses without fused_mlm_xent, ROADMAP C1)
TP_PATHS = {"heads_major": dict(KERNELS, packed_qkv=False, fused_mlm_xent=True),
            "save_probs": dict(KERNELS, flash_save_probs=True, fused_mlm_xent=True),
            "einsum": {}}


@pytest.mark.parametrize("path", sorted(TP_PATHS))
def test_model_axis_paths_equal_one_process(tp_runs, path):
    """(1, 2) with the heads-major attention (its context re-laid out
    before the row-parallel product), the saved-probabilities attention,
    and the einsum attention with the eager LayerNorm and the unfused
    decoder: losses and every parameter as JAX's mesh run of the path and
    as one process."""
    batches = tp_runs["jax"][3]
    start, want, want_end = tp_runs["paths"][path]
    assert_ranks_agree(tp_runs["results"], path)
    got = tp_runs["results"][0][path]
    assert_metrics(got["metrics"], want, MLM_KEYS)
    assert_params(got["params"], want_end)
    one, one_end = one_process(start, "pretraining", batches, TP_PATHS[path])
    assert_metrics(got["metrics"], one, MLM_KEYS)
    assert_params(got["params"], one_end)


def test_gathered_holds_whole_parameters_then_the_shard(tp_runs):
    """Within Trainer.gathered() (the .th restore's block) every rank holds
    the whole parameters; after it and a second init_state, its shard
    again, the optimizer's Parameters included."""
    start = tp_runs["jax"][0]
    for r in tp_runs["results"]:
        g = r["gathered"]
        for k, v in g["inside"].items():
            np.testing.assert_array_equal(v.numpy(), start[k], err_msg=k)
            dim = model_split_dim(k)
            want = list(start[k].shape)
            if dim is not None:
                want[dim] //= 2
            assert g["after"][k] == tuple(want) and g["adam"][k] == tuple(want), k


def test_model_axis_matches_jax(tp_runs):
    """(1, 2) with the attention kernels, the fused LayerNorm, the site
    kernels and the fused cross-entropy (plain versions here; JAX without
    fused_mlm_xent, ROADMAP C1): losses and every parameter equal JAX's
    mesh run and the port's one-process run."""
    results = tp_runs["results"]
    start, want, want_end, batches = tp_runs["jax"]
    assert_ranks_agree(results, "train")
    got = results[0]["train"]
    assert_metrics(got["metrics"], want, MLM_KEYS)
    assert_params(got["params"], want_end)
    one, one_end = port_run(start, "pretraining", batches, tp_runs["port_flags"])
    assert_metrics(got["metrics"], one, MLM_KEYS)
    assert_params(got["params"], one_end)


def test_mlm_xent_under_the_mesh_equals_one_rank(tp_runs):
    """nll, argmax and the gradients of the rows split over two model ranks
    equal the one-rank op; every rank holds the whole result."""
    d = tp_runs["xent"]
    x, emb, bias = (torch.tensor(d[k], requires_grad=True) for k in ("x", "emb", "bias"))
    nll, am = mlm_xent(x, emb, bias, torch.tensor(d["labels"]))
    (nll * torch.tensor(d["g"])).sum().backward()
    want = {"nll": nll.detach(), "argmax": am, "dx": x.grad, "de": emb.grad, "db": bias.grad}
    for r in tp_runs["results"]:
        got = r["xent"]
        assert torch.equal(got["argmax"], want["argmax"]) and got["argmax"].dtype == torch.int32
        for k in ("nll", "dx", "de", "db"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=1e-6, err_msg=k)


def test_unfused_fallback_when_rows_do_not_split(tp_runs):
    """9 MLM rows over 2 model ranks: supports_mesh is false, the head takes
    the unfused decoder (no fused call), and loss and gradients equal the
    one-process fused run."""
    model = load_state(VisualBertForTask(VisualBertConfig(**SMALL, dtype=torch.float32, **tp_runs["port_flags"]),
                                         "pretraining"), tp_runs["jax"][0])
    out = model(tp_runs["odd"])
    out["loss"].backward()
    for r in tp_runs["results"]:
        got = r["unfused"]
        assert got["fused_calls"] == 0
        np.testing.assert_allclose(got["loss"], float(out["loss"].detach()), atol=ATOL, rtol=RTOL)
        for k, p in model.named_parameters():
            if p.grad is not None:
                np.testing.assert_allclose(got["grads"][k].numpy(), p.grad.numpy(), atol=ATOL, rtol=RTOL, err_msg=k)


def test_bert_adam_clips_split_tensors_by_their_whole_norm(tp_runs):
    """Every tensor clips (max_grad_norm 1e-3): BertAdam on the model ranks'
    shards, the Q/K/V group and the FFN tensors split, equals the one-rank
    BertAdam; a per-shard norm would not."""
    params, grads, opt = tp_runs["adam"]
    named = {k: torch.nn.Parameter(v.clone()) for k, v in params.items()}
    adam = BertAdam(named.items(), OptimizerConfig(**opt))
    for g in grads:
        for k, v in g.items():
            named[k].grad = v.clone()
        adam.step()
    split = [k for k in params if model_split_dim(k) is not None]
    assert len(split) == 9
    for r in tp_runs["results"]:
        assert r["adam"]["split"] == sorted(split)
        for k, p in named.items():
            np.testing.assert_allclose(r["adam"]["params"][k].numpy(), p.detach().numpy(), atol=1e-7, rtol=1e-6,
                                       err_msg=k)


def test_checkpoints_restore_across_mesh_shapes(tp_runs, tmp_path):
    """A one-process checkpoint restores at (1, 2) equal (the ranks hold
    halves of the split tensors), and the checkpoint the (1, 2) ranks write
    restores in one process strict and equal."""
    one = tp_runs["one"]
    want = {k: v.detach() for k, v in one.model.named_parameters()}
    for r in tp_runs["results"]:
        got = r["checkpoint"]
        for k, v in want.items():
            assert torch.equal(got["params"][k], v), k
        split = [k for k in want if model_split_dim(k) is not None]
        assert split and all(got["local_shapes"][k][model_split_dim(k)] * 2 == want[k].shape[model_split_dim(k)]
                             for k in split)
    fresh = Trainer(VisualBertForTask(VisualBertConfig(**SMALL, dtype=torch.float32), "pretraining"),
                    OptimizerConfig(), TrainConfig(seed=1), "cpu").init_state()
    CheckpointManager(os.path.dirname(tp_runs["results"][0]["checkpoint"]["path"])).restore(fresh)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, one.model.state_dict()[k]), k
    assert fresh.step == one.step


@pytest.fixture(scope="module")
def dp_tp_runs(tmp_path_factory):
    """(2, 2): the model axis with data ranks, and three steps with dropout on."""
    pb = pretrain_batches(STEPS)
    unsup = unsup_parts()
    runs = {"train": task_run((2, 2), "pretraining", pb, KERNELS), "unsup": unsup["run"]}
    start = runs["train"].start
    port_flags = dict(KERNELS, fused_mlm_xent=True)
    dropout = dict(port_flags, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    jobs = [train_job((2, 2), "pretraining", start, pb, port_flags),
            ("dropout", dict(job="train", **train_job((2, 2), "pretraining", start, pb, dropout, record=True,
                                                      local_state=True)[1])),
            ("unsup", dict(job="train", **train_job((2, 2), None, runs["unsup"].start, unsup["batches"], port_flags,
                                                    kind="unsupervised", kind_kw=unsup["kind_kw"])[1]))]
    results, jax_out = launch_beside(jobs, 4, tmp_path_factory.mktemp("dptp"), runs)
    return dict(results=results, jax=jax_out["train"] + (pb,), unsup_jax=jax_out["unsup"], unsup=unsup,
                port_flags=port_flags)


def unsup_parts():
    """The unsupervised model (three streams, tags, the object, attribute,
    feature and QA heads) and STEPS V&L batches of 4 rows; its JaxRun on
    (2, 2) with the attention and dropout kernels (JAX without
    fused_mlm_xent, ROADMAP C1)."""
    from test_torch_unsupervised import F, N_ANS, N_ATTR, N_OBJ, N_SYM, make_batch
    from visualbert_tpu.models import unsupervised as jax_unsup
    from visualbert_torch.tools.weights import unsupervised_state

    # JAX splits the symbolic vocabulary over its model axis: even, one
    # unused row past the tags the batches draw
    kind_kw = dict(visual_feat_dim=F, obj_id_num=N_OBJ, attr_id_num=N_ATTR, symbolic_vocab_size=N_SYM + 1,
                   num_answers=N_ANS)
    batches = []
    for seed in range(STEPS):
        b = make_batch("vl", seed=seed, B=4)
        b["ans"] = np.array([1, -1, 3, 0], np.int32)
        b["input_ids"] %= SMALL["vocab_size"]
        b["masked_lm_labels"] = np.where(b["masked_lm_labels"] >= 0, b["masked_lm_labels"] % SMALL["vocab_size"], -1)
        batches.append(b)
    run = JaxRun(lambda mesh: jax_unsup.UnsupervisedVisualBert(jax_unsup.UnsupervisedConfig(
        bert=JaxConfig(**SMALL, dtype=jnp.float32, **KERNELS, mesh=mesh), **kind_kw)), (2, 2), batches,
        unsupervised_state)
    return dict(kind_kw=kind_kw, batches=batches, run=run)


def test_data_and_model_axes_match_jax(dp_tp_runs):
    results = dp_tp_runs["results"]
    _, want, want_end, _ = dp_tp_runs["jax"]
    assert_ranks_agree(results, "train")
    assert_metrics(results[0]["train"]["metrics"], want, MLM_KEYS)
    assert_params(results[0]["train"]["params"], want_end)


def test_unsupervised_model_on_both_axes_equals_one_process(dp_tp_runs):
    """UnsupervisedVisualBert on (2, 2) with the kernels' plain versions and
    the fused cross-entropy over every text row: losses and every parameter
    as JAX's mesh run (unfused, ROADMAP C1) and as one process."""
    u = dp_tp_runs["unsup"]
    start, want, want_end = dp_tp_runs["unsup_jax"]
    assert_ranks_agree(dp_tp_runs["results"], "unsup")
    got = dp_tp_runs["results"][0]["unsup"]
    keys = ("loss", "masked_lm_loss", "matched_loss", "obj_loss", "attr_loss", "feat_loss")
    assert_metrics(got["metrics"], want, keys)
    assert_params(got["params"], want_end)
    one, one_end = one_process(start, None, u["batches"], dp_tp_runs["port_flags"], kind="unsupervised",
                               kind_kw=u["kind_kw"])
    assert_metrics(got["metrics"], one, keys)
    assert_params(got["params"], one_end)


def test_dropout_keeps_replicas_equal_and_attention_seeds_apart(dp_tp_runs):
    """Dropout 0.1 on (2, 2), three steps: within each model group the
    hidden-state sites (the embeddings' site kernel and K9) draw the same
    seeds, the data index's, so before the trainer's broadcast every
    gradient of a parameter the group holds whole is equal on both peers,
    and after it those parameters are bit-equal; the split ones differ
    between the peers, and the attention seeds differ on all four ranks."""
    res = {r["dropout"]["index"]: r["dropout"] for r in dp_tp_runs["results"]}
    assert sorted(res) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    n_layers = SMALL["num_hidden_layers"]
    for di in (0, 1):
        a, b = res[(di, 0)], res[(di, 1)]
        assert len(a["seeds"]["site"]) == STEPS and len(a["seeds"]["k9"]) == STEPS * 2 * n_layers
        assert a["seeds"]["site"] == b["seeds"]["site"] and a["seeds"]["k9"] == b["seeds"]["k9"]
        assert len(b["grad_gaps"]) == STEPS
        for step in b["grad_gaps"]:
            assert step and all(g == 0.0 for g in step.values()), step
        for k, v in a["local"].items():
            if model_split_dim(k) is None:
                assert torch.equal(v, b["local"][k]), k
            else:
                assert not torch.equal(v, b["local"][k]), k
    assert res[(0, 0)]["seeds"]["site"] != res[(1, 0)]["seeds"]["site"]
    assert not set(res[(0, 0)]["seeds"]["k9"]) & set(res[(1, 0)]["seeds"]["k9"])
    first = [r["seeds"]["attention"] for r in res.values()]
    assert all(len(s) == STEPS * SMALL["num_hidden_layers"] for s in first)
    for step_layer in zip(*first):
        assert len(set(step_layer)) == 4
    assert all(np.isfinite(m["loss"]) for m in res[(0, 0)]["metrics"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """train_cli under two ranks (RANK / WORLD_SIZE / MASTER_ADDR as
    torchrun sets them): a synthetic NLVR2 epoch on "mesh_shape": [2, 1],
    then flickr_probe on [2, 1] and on [1, 2], one launch; and each run in
    one process."""
    from test_torch_probing import probe_raw
    from visualbert_torch import train_cli

    tmp = tmp_path_factory.mktemp("cli")
    nlvr2 = {"task": "nlvr2", "data": {"synthetic": 40, "max_seq_length": 12, "max_regions_per_image": 6},
             "model": dict(SMALL, vocab_size=128, dtype="float32", use_flash_attention=True, fast_dropout=True),
             "optimizer": {"learning_rate": 1e-3, "schedule": "none"},
             "train": {"train_batch_size": 8, "eval_batch_size": 4, "num_train_epochs": 1, "num_workers": 0}}
    runs = {"nlvr2": (nlvr2, [2, 1]), "probe_dp": (probe_raw(13, False), [2, 1]),
            "probe_tp": (probe_raw(13, False), [1, 2])}
    one, jobs = {}, []
    for name, (raw, shape) in runs.items():
        path = tmp / f"{name}.json"
        path.write_text(json.dumps(raw))
        one[name] = train_cli.main(["--config", str(path), "--folder", str(tmp / name / "one"), "--device", "cpu"])
        raw = dict(raw, train=dict(raw["train"], mesh_shape=shape))
        path = tmp / f"{name}_mesh.json"
        path.write_text(json.dumps(raw))
        jobs.append((name, dict(job="cli", argv=["--config", str(path), "--folder", str(tmp / name / "two"),
                                                 "--device", "cpu"])))
    env = {"RANK": "{rank}", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    return dict(one=one, results=launch(jobs, 2, tmp / "launch", env=env), tmp=tmp)


def test_cli_two_ranks_equal_one_process(cli_runs):
    """The NLVR2 epoch on [2, 1]: its history and weights equal the
    one-process run's; rank 0 writes the checkpoint, each rank its slice of
    the report."""
    one, want = cli_runs["one"]["nlvr2"]
    tmp = cli_runs["tmp"] / "nlvr2"
    for r in cli_runs["results"]:
        got = r["nlvr2"]
        assert got["mesh"] == (2, 1) and got["step"] == 4
        assert set(got["history"][0]) == set(want.history[0])
        for k, v in want.history[0].items():
            np.testing.assert_allclose(got["history"][0][k], v, atol=ATOL, rtol=RTOL, err_msg=k)
        assert_params(got["params"], {k: p.detach().numpy() for k, p in one.model.named_parameters()})
    assert sorted(os.listdir(tmp / "two" / "ckpt")) == ["best.pt", "step_4.pt"]
    rows = [(tmp / "two" / f"rank_{r}" / "nlvr2_report.csv").read_text().splitlines() for r in (0, 1)]
    assert sorted(rows[0] + rows[1]) == sorted((tmp / "one" / "nlvr2_report.csv").read_text().splitlines())


@pytest.mark.parametrize("name,shape", [("probe_dp", (2, 1)), ("probe_tp", (1, 2))])
def test_probe_under_a_mesh_equals_one_process(cli_runs, name, shape):
    """flickr_probe over 13 entities' rows (the last batch padded, its
    repeats on rank 1 under [2, 1]): the data ranks' counts summed, the
    model ranks' heads gathered; flickr_probe.json (rank 0 writes it)
    equals the one-process file."""
    tmp = cli_runs["tmp"] / name
    assert all(r[name]["mesh"] == shape for r in cli_runs["results"])
    want = json.loads((tmp / "one" / "flickr_probe.json").read_text())
    assert json.loads((tmp / "two" / "flickr_probe.json").read_text()) == want and want["entities"] > 0


def test_mesh_shape_is_read_from_a_config():
    """"mesh_shape" is a TrainConfig field, not a skipped TPU-only one;
    steps_per_dispatch and compiler_options still are skipped."""
    from visualbert_torch.utils.config_io import parse_task_config

    cfg = parse_task_config({"task": "nlvr2", "train": {"mesh_shape": [2, 4], "steps_per_dispatch": 8}})
    assert cfg.train.mesh_shape == (2, 4) and TrainConfig().mesh_shape == (1, 1)


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2"}, {"RANK": "0", "WORLD_SIZE": "2", "STORE": "1"}],
                         ids=["no_rank", "peer_never_comes"])
def test_a_configured_launch_that_cannot_come_up_raises(tmp_path, env):
    """WORLD_SIZE without RANK, or a second rank that never arrives (a
    file store, 1 s timeout): train_cli's bring-up raises instead of
    training alone."""
    import subprocess

    code = ("import os; from visualbert_torch.parallel import distributed as d; "
            "d.initialize_distributed('cpu', init_method=('file://' + os.environ['STORE_PATH']) "
            "if os.environ.get('STORE') else None, timeout_s=1)")
    e = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    e.update(env, STORE_PATH=str(tmp_path / "store"),
             PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-c", code], env=e, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert ("RANK and WORLD_SIZE" in proc.stderr) if "RANK" not in env else ("Error" in proc.stderr)


@pytest.mark.parametrize("build", ["pretraining", "bypass", "unsupervised", "vcr"])
def test_parameter_axes_split_exactly_the_encoder_layers(build):
    """The table splits, in every model of the port, the Q/K/V and FFN-up
    rows and the two row-parallel weights of each TransformerLayer, and
    nothing else (not the vocabulary)."""
    from visualbert_torch.models.encoder import TransformerLayer

    cfg = VisualBertConfig(**SMALL, dtype=torch.float32)
    if build == "unsupervised":
        from visualbert_torch.models.unsupervised import UnsupervisedConfig, UnsupervisedVisualBert

        model = UnsupervisedVisualBert(UnsupervisedConfig(bert=cfg, visual_feat_dim=24, obj_id_num=5,
                                                          attr_id_num=3, symbolic_vocab_size=8))
    elif build == "vcr":
        from visualbert_torch.models.vcr import VisualBertDetectorModel

        model = VisualBertDetectorModel(cfg, head_type="multichoice", final_dim=16, trunk_blocks=(1, 1, 1),
                                        layer4_blocks=1, width_div=8)
    else:
        model = VisualBertForTask(cfg.replace(bypass_transformer=build == "bypass"), "pretraining")
    want = set()
    for prefix, mod in model.named_modules():
        if isinstance(mod, TransformerLayer):
            want |= {f"{prefix}.{n}" for n in
                     [f"attention.self.{q}.{w}" for q in ("query", "key", "value") for w in ("weight", "bias")]
                     + ["attention.output.dense.weight", "intermediate.dense.weight", "intermediate.dense.bias",
                        "output.dense.weight"]}
    got = {k for k, _ in model.named_parameters() if model_split_dim(k) is not None}
    assert want and got == want
