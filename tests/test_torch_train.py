"""visualbert_torch training on the CPU against the JAX package.

BertAdam is held against the JAX optimizer (``from_config``, the optax
transform the JAX Trainer uses) over 12 steps for each schedule, at
rtol 1e-6. The Trainer runs 3 steps against the JAX Trainer from the same
exported weights with dropout probabilities 0, at the bar of
``tests/test_training_parity.py`` (rtol and atol 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import OptimizerConfig as JaxOptConfig
from visualbert_tpu.config import TrainConfig as JaxTrainConfig
from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.parallel.mesh import create_mesh
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train import optimizer as jax_opt
from visualbert_tpu.train.trainer import Trainer as JaxTrainer
from visualbert_tpu.train.trainer import unbox
from visualbert_torch.config import OptimizerConfig, TrainConfig, VisualBertConfig
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.tools.weights import load_state
from visualbert_torch.train.optimizer import BertAdam, decays, make_schedule
from visualbert_torch.train.trainer import Trainer

SCHEDULES = [("warmup_linear", 10), ("warmup_constant", 10), ("warmup_cosine", 10), ("none", -1)]


def optimizer_case(rng):
    shapes = {"dense": {"kernel": (5, 7), "bias": (7,)}, "norm": {"scale": (7,)},
              "pooler": {"kernel": (7, 7)}}
    params = {m: {k: rng.randn(*s).astype(np.float32) for k, s in d.items()} for m, d in shapes.items()}
    scales = (0.1, 5.0, 1.0, 0.01, 2.0, 0.3, 3.0, 0.05, 1.5, 0.7, 4.0, 0.2)  # some steps clip
    grads = [{m: {k: (rng.randn(*s) * sc).astype(np.float32) for k, s in d.items()} for m, d in shapes.items()}
             for sc in scales]
    return params, grads


@pytest.mark.parametrize("schedule,t_total", SCHEDULES)
def test_bert_adam_matches_jax(rng, schedule, t_total):
    params, grads = optimizer_case(rng)
    kw = dict(learning_rate=1e-2, schedule=schedule, warmup=0.3, t_total=t_total, frozen=("pooler",))
    tx = jax_opt.from_config(JaxOptConfig(**kw))
    p = jax.tree.map(jnp.asarray, params)
    state = tx.init(p)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, p)
        p = jax.tree.map(lambda a, b: a + b, p, updates)

    named = {f"{m}.{k}": torch.nn.Parameter(torch.tensor(v)) for m, d in params.items() for k, v in d.items()}
    opt = BertAdam(named.items(), OptimizerConfig(**kw))
    for g in grads:
        for m, d in g.items():
            for k, v in d.items():
                named[f"{m}.{k}"].grad = torch.tensor(v)
        opt.step()
    for m, d in p.items():
        for k, v in d.items():
            np.testing.assert_allclose(named[f"{m}.{k}"].detach().numpy(), np.asarray(v), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(named["pooler.kernel"].detach().numpy(), params["pooler"]["kernel"])
    assert int(state.step) == opt.step_count == len(grads)


def test_schedule_values_and_first_warmup_step():
    for name, t_total in SCHEDULES:
        ours = make_schedule(name, 0.3, t_total)
        theirs = jax_opt.make_schedule(name, 0.3, t_total)
        for step in range(12):
            assert float(ours(step)) == pytest.approx(float(theirs(jnp.asarray(step))), rel=1e-6, abs=1e-7)
    assert float(make_schedule("warmup_linear", 0.1, 100)(0)) == 0.0  # lr 0 on the first update


def test_decay_mask_by_name():
    assert decays("bert.encoder.layer.0.attention.self.query.weight")
    assert decays("bert.embeddings.word_embeddings.weight")
    assert not decays("bert.encoder.layer.0.attention.self.query.bias")
    assert not decays("bert.embeddings.LayerNorm.weight")
    assert not decays("cls.predictions.bias")
    assert not decays("cls.predictions.transform.LayerNorm.bias")


def numpy_bert_adam(params, grads, lr, max_norm, clip_groups, b1=0.9, b2=0.999, eps=1e-6):
    """BertAdam without weight decay or schedule, in numpy: the gradients of
    each name group in ``clip_groups`` are clipped by their joint norm."""
    p = {k: v.astype(np.float32).copy() for k, v in params.items()}
    m = {k: np.zeros_like(v) for k, v in p.items()}
    v2 = {k: np.zeros_like(v) for k, v in p.items()}
    for g in grads:
        g = {k: x.astype(np.float32) for k, x in g.items()}
        for group in clip_groups:
            norm = np.sqrt(sum(np.sum(g[k].astype(np.float64) ** 2) for k in group))
            for k in group:
                g[k] = g[k] * min(1.0, max_norm / (norm + 1e-6))
        for k in p:
            m[k] = b1 * m[k] + (1 - b1) * g[k]
            v2[k] = b2 * v2[k] + (1 - b2) * g[k] * g[k]
            p[k] = p[k] - lr * m[k] / (np.sqrt(v2[k]) + eps)
    return p


QKV = ("attention.self.query.", "attention.self.key.", "attention.self.value.")


def test_bert_adam_clips_query_key_value_by_their_joint_norm(rng):
    """Each layer's query, key and value weights are clipped by one joint
    norm, and their biases by another (the JAX package's fused QKV tensor,
    ROADMAP.md C3): the port matches a numpy BertAdam with those clip
    groups, on a case that a per-tensor clip would not match."""
    names = [f"bert.encoder.layer.{i}.{q}{w}" for i in (0, 1) for q in QKV for w in ("weight", "bias")]
    names += ["bert.encoder.layer.0.attention.output.dense.weight", "cls.predictions.bias"]
    shapes = {n: (8, 8) if n.endswith("weight") else (8,) for n in names}
    params = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    # query clips every step, key never, value on the first step only
    scale = {"query": (3.0, 2.0, 5.0), "key": (0.01, 0.02, 0.05), "value": (2.0, 0.05, 0.1),
             "dense": (2.0, 0.01, 1.0), "predictions": (0.5, 3.0, 0.01)}
    grads = [{n: (rng.randn(*s) * scale[n.split(".")[-2]][t]).astype(np.float32) for n, s in shapes.items()}
             for t in range(3)]
    lr = 1e-2
    named = {n: torch.nn.Parameter(torch.tensor(v)) for n, v in params.items()}
    opt = BertAdam(named.items(), OptimizerConfig(learning_rate=lr, schedule="none", weight_decay=0.0))
    for g in grads:
        for n, v in g.items():
            named[n].grad = torch.tensor(v)
        opt.step()
    groups = [[f"bert.encoder.layer.{i}.{q}{w}" for q in QKV] for i in (0, 1) for w in ("weight", "bias")]
    groups += [[n] for n in names[-2:]]
    assert sorted(map(sorted, opt.clip_groups)) == sorted(map(sorted, groups))
    joint = numpy_bert_adam(params, grads, lr, 1.0, groups)
    own = numpy_bert_adam(params, grads, lr, 1.0, [[n] for n in names])
    for n in names:
        np.testing.assert_allclose(named[n].detach().numpy(), joint[n], rtol=1e-6, atol=1e-7, err_msg=n)
    assert max(np.abs(own[n] - joint[n]).max() for n in names) > 1e-3  # the case tells the two apart


def test_bert_adam_equals_jax_optimizer_on_every_leaf_when_all_clip(rng):
    """From the same weights and gradients, two steps where every gradient
    tensor clips (the fused QKV ones by their joint norm), then one where no
    QKV gradient clips: the port equals the JAX optimizer on every
    parameter."""
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32)
    batch = batches(rng, 1)[0]
    jm = JaxTask(jcfg, head_type="pretraining")
    params = unbox(jm.init(jax.random.PRNGKey(4), batch)["params"])
    jbatch = jax.tree.map(jnp.asarray, batch)
    grads = jax.grad(lambda p: jm.apply({"params": p}, jbatch, deterministic=True)["loss"])(params)

    model = load_state(VisualBertForTask(VisualBertConfig(**SMALL, dtype=torch.float32), "pretraining"),
                       export_state_dict(params, jcfg))
    names = dict(model.named_parameters())
    g_t = {k: v for k, v in export_state_dict(grads, jcfg).items() if k in names}
    sq = {k: float(np.sum(np.square(v, dtype=np.float64))) for k, v in g_t.items()}
    # the key bias's gradient is zero but for rounding (softmax is shift-invariant)
    big = 10.0 / np.sqrt(min(x for x in sq.values() if x > 1e-12))  # every tensor clips
    qkv = [k for k in names if any(q in k for q in QKV)]
    fused = [np.sqrt(sum(sq[k] for k in qkv if k.startswith(f"bert.encoder.layer.{i}.") and k.endswith(w)))
             for i in range(SMALL["num_hidden_layers"]) for w in ("weight", "bias")]
    small = 0.5 / max(fused)  # no QKV tensor clips
    steps = (big, 2 * big, small)
    lr = 1e-2
    kw = dict(learning_rate=lr, schedule="none", weight_decay=0.0, max_grad_norm=1.0)

    tx = jax_opt.from_config(JaxOptConfig(**kw))
    p_j, state = params, tx.init(params)
    for s in steps:
        updates, state = tx.update(jax.tree.map(lambda g: g * s, grads), state, p_j)
        p_j = jax.tree.map(lambda a, b: a + b, p_j, updates)
    want = export_state_dict(jax.device_get(p_j), jcfg)

    start = {k: p.detach().numpy().copy() for k, p in names.items()}
    opt = BertAdam(names.items(), OptimizerConfig(**kw))
    for s in steps:
        for k, p in names.items():
            p.grad = torch.tensor(g_t[k] * np.float32(s))
        opt.step()
    # QKV atol 3e-7: XLA and torch sum the joint norm in other orders; those
    # leaves read up to 1.3e-7 apart at this size
    for k, p in names.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=1e-6, atol=3e-7 if k in qkv else 1e-7,
                                   err_msg=k)
    # the per-tensor clip of the reference would have moved the QKV leaves apart
    own = numpy_bert_adam(start, [{k: v * np.float32(s) for k, v in g_t.items()} for s in steps],
                          lr, 1.0, [[k] for k in names])
    assert max(np.abs(own[k] - want[k]).max() for k in qkv) > 1e-4


SMALL = dict(vocab_size=97, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=128, max_position_embeddings=64, visual_embedding_dim=24,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0, use_flash_attention=True,
             fast_dropout=True)
B, TT, TV, P = 4, 11, 8, 3


def batches(rng, n):
    out = []
    for _ in range(n):
        lm = np.full((B, TT), -1, np.int32)
        pos = np.zeros((B, P), np.int32)
        for i in range(B):
            p = np.sort(rng.choice(np.arange(1, TT), size=P, replace=False))
            pos[i] = p
            lm[i, p] = rng.randint(0, SMALL["vocab_size"], size=P)
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
            "is_random_next": rng.randint(0, 2, (B,)).astype(np.int32),
        })
    return out


def test_trainer_three_steps_match_jax_trainer(rng):
    data = batches(rng, 3)
    opt = dict(learning_rate=1e-3, schedule="warmup_linear", warmup=0.3, t_total=6, frozen=("pooler",))
    jcfg = JaxConfig(**SMALL, dtype=jnp.float32)
    jtrainer = JaxTrainer(JaxTask(jcfg, head_type="pretraining"), JaxOptConfig(**opt),
                          JaxTrainConfig(), create_mesh((1, 1), devices=jax.devices()[:1]))
    state = jtrainer.init_state(jax.random.PRNGKey(0), data[0])
    step = jtrainer.train_step_fn()
    model = load_state(VisualBertForTask(VisualBertConfig(**SMALL, dtype=torch.float32), "pretraining"),
                       export_state_dict(jax.device_get(state.params), jcfg))
    trainer = Trainer(model, OptimizerConfig(**opt), TrainConfig(seed=0), device="cpu").init_state(init_weights=False)

    ours, theirs = [], []
    for b in data:
        state, metrics = step(state, jtrainer.shard_batch(b), jax.random.PRNGKey(1))
        theirs.append([float(metrics[k]) for k in ("loss", "masked_lm_loss", "next_sentence_loss")])
        m = trainer.train_step(b)
        ours.append([float(m[k]) for k in ("loss", "masked_lm_loss", "next_sentence_loss")])
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-4)
    want = export_state_dict(jax.device_get(state.params), jcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=2e-4, atol=2e-4, err_msg=name)


def test_gradient_accumulation_averages_microbatches(rng):
    data = batches(rng, 1)[0]
    cfg = VisualBertConfig(**SMALL, dtype=torch.float32)
    opt = OptimizerConfig(learning_rate=1e-3, schedule="none")

    def run(accum, batch):
        t = Trainer(VisualBertForTask(cfg, "pretraining"), opt,
                    TrainConfig(seed=3, gradient_accumulation_steps=accum), device="cpu").init_state()
        m = t.train_step(batch)
        return m, {k: p.detach().clone() for k, p in t.model.named_parameters()}

    # two identical microbatches average to the single-batch gradient
    stacked = {k: np.stack([v, v]) for k, v in data.items()}
    m1, p1 = run(1, data)
    m2, p2 = run(2, stacked)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-6)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=1e-5, atol=1e-7)


def test_nan_guard_skips_the_update(rng):
    data = batches(rng, 1)[0]
    bad = dict(data, visual_embeddings=np.full_like(data["visual_embeddings"], np.nan))
    cfg = VisualBertConfig(**SMALL, dtype=torch.float32)
    t = Trainer(VisualBertForTask(cfg, "pretraining"), OptimizerConfig(learning_rate=1e-3, schedule="none"),
                TrainConfig(seed=0, nan_guard=True), device="cpu").init_state()
    before = {k: p.detach().clone() for k, p in t.model.named_parameters()}
    m = t.train_step(bad)
    assert float(m["skipped_nonfinite"]) == 1.0 and t.step == 1 and t.optimizer.step_count == 0
    for k, p in t.model.named_parameters():
        torch.testing.assert_close(p.detach(), before[k], rtol=0, atol=0)
    m = t.train_step(data)
    assert float(m["skipped_nonfinite"]) == 0.0 and t.optimizer.step_count == 1


def test_dropout_is_reproducible_from_the_seed(rng):
    data = batches(rng, 1)[0]
    cfg = VisualBertConfig(**dict(SMALL, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1),
                           dtype=torch.float32)
    losses = []
    for seed in (5, 5, 6):
        t = Trainer(VisualBertForTask(cfg, "pretraining"), OptimizerConfig(learning_rate=1e-3, schedule="none"),
                    TrainConfig(seed=seed), device="cpu").init_state()
        # the same weights for all three runs; only the dropout stream differs by seed
        t.model.init_weights(torch.Generator().manual_seed(0))
        losses.append([float(t.train_step(data)["loss"]) for _ in range(2)])
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]


def test_stock_dropout_path_trains(rng):
    """fast_dropout off and the einsum attention: dropout through
    ``seeded_dropout``, on only when a dropout generator is passed. Its masks
    come from that generator, not torch's global one: the same seed gives the
    same loss whatever the global state, and the generator's next draws a
    different one."""
    data = {k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
            for k, v in batches(rng, 1)[0].items()}
    cfg = VisualBertConfig(**dict(SMALL, hidden_dropout_prob=0.3, attention_probs_dropout_prob=0.3,
                                  fast_dropout=False, use_flash_attention=False), dtype=torch.float32)
    model = VisualBertForTask(cfg, "pretraining").init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        det = [float(model(data)["loss"]) for _ in range(2)]
        drop = []
        for global_seed in (0, 1):
            torch.manual_seed(global_seed)
            drop.append(float(model(data, torch.Generator().manual_seed(1))["loss"]))
        g = torch.Generator().manual_seed(1)
        steps = [float(model(data, g)["loss"]) for _ in range(2)]
    assert det[0] == det[1]
    assert all(np.isfinite(drop)) and drop[0] == drop[1] == steps[0] and drop[0] != det[0]
    assert steps[1] != steps[0]
