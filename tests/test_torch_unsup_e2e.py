"""The end-to-end unsupervised model in the port (``UnsupervisedEndToEnd``:
the detector inside the unsupervised training graph), its weight bridge
``unsup_e2e_state``, its weight-decay decision and ``tools/unsup_e2e_path.py``,
against the JAX package on the CPU.

The JAX model runs once, jitted, in a module fixture at its own test's size
(``tests/test_unsup_e2e.py``: trunk (1, 1, 1), one layer4 block, width_div
4, 32 x 32 images, B = 2, N = 3, the tiny encoder in fp32, dropout 0), with
the 7 x 7 stem (through the s2d stem the gradients differ by up to 1e-3).
Weights cross over from its init; outputs and the five losses agree at
atol 2e-5 / rtol 1e-4, every gradient, the detector's included, at atol
2e-5 plus rtol 1e-4 of its tensor's largest entry, and three BertAdam steps
within 2e-4. (The gradients are held to their tensor's scale because the
region stream's LayerNorm over the detector's raw features makes
``visn_fc``'s gradient ~5e4, whose sum over tokens cancels to ~17 in one
entry; there fp32 rounding alone moves it by ~1e-2.) The detector's predicted classes must be
equal in both, and every box's top-two logit margin must exceed the logit
tolerance, so that no near tie decides a tag."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import OptimizerConfig as JaxOptimizerConfig
from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.models import detector as jax_det
from visualbert_tpu.models import unsup_e2e as jax_e2e
from visualbert_tpu.models.unsupervised import UnsupervisedConfig as JaxUnsupConfig
from visualbert_tpu.tools.export_torch import export_resnet50_state_dict
from visualbert_tpu.tools.import_torch import convert_lxrt_state_dict, convert_resnet50_state_dict
from visualbert_tpu.train.optimizer import default_decay_mask
from visualbert_tpu.train.optimizer import from_config as jax_optimizer
from visualbert_tpu.train.trainer import unbox
from visualbert_torch.config import OptimizerConfig, TrainConfig, VisualBertConfig
from visualbert_torch.models.unsup_e2e import UnsupervisedEndToEnd, detector_flax_path
from visualbert_torch.models.unsupervised import UnsupervisedConfig, flax_path
from visualbert_torch.tools.weights import load_state, unsup_e2e_state
from visualbert_torch.train.optimizer import BertAdam
from visualbert_torch.train.trainer import Trainer, to_device

ATOL, RTOL, TRAJ_TOL = 2e-5, 1e-4, 2e-4
LOGIT_TOL = ATOL + RTOL * 10  # the logits' agreement bar at their size (|logit| < 10 here)
TINY_DET = dict(trunk_blocks=(1, 1, 1), layer4_blocks=1, width_div=4)
C2S = tuple(range(81))
LOSSES = ("masked_lm_loss", "matched_loss", "obj_loss", "feat_loss", "masked_tag_loss")
OPT = dict(learning_rate=1e-3, schedule="none", weight_decay=0.01, max_grad_norm=1.0,
           no_decay=("bias", "layer_norm", "LayerNorm"))
STEPS = 3


def make_batch(rng, B=2, N=3, T=6, img=32, vocab=128):
    """The JAX test's batch (``tests/test_unsup_e2e.py::make_batch``)."""
    boxes = np.zeros((B, N, 4), np.float32)
    for b in range(B):
        for n in range(N):
            x = rng.uniform(0, img - 12)
            y = rng.uniform(0, img - 12)
            boxes[b, n] = [x, y, x + 10, y + 10]
    lm = np.full((B, T), -1, np.int32)
    lm[:, 2] = rng.randint(0, vocab, size=B)
    return {
        "images": rng.randn(B, img, img, 3).astype(np.float32),
        "boxes": boxes,
        "boxes_norm": boxes / img,
        "box_mask": np.ones((B, N), np.int32),
        "input_ids": rng.randint(0, vocab, size=(B, T)).astype(np.int32),
        "token_type_ids": np.zeros((B, T), np.int32),
        "input_mask": np.ones((B, T), np.int32),
        "masked_lm_labels": lm,
        "matched_label": np.ones(B, np.int32),
        "feat_mask": (rng.rand(B, N) < 0.4).astype(np.int32),
        "tag_mask": (rng.rand(B, N) < 0.4).astype(np.int32),
    }


def configs():
    kw = dict(vocab_size=128, visual_embedding_dim=512, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    sizes = dict(visual_feat_dim=512, obj_id_num=81, attr_id_num=4, symbolic_vocab_size=81 + 4 + 3)
    return (JaxUnsupConfig(bert=JaxConfig.tiny(**kw), **sizes),
            UnsupervisedConfig(bert=VisualBertConfig.tiny(**kw), **sizes))


def port_state(params):
    return unsup_e2e_state(export_resnet50_state_dict(params["detector"]), params["trunk"])


@pytest.fixture(scope="module")
def jax_side():
    return run_jax()


def run_jax():
    """The JAX model's init, forward, gradients, detector logits and a
    three-step BertAdam trajectory on the batch, each jitted once."""
    jcfg, _ = configs()
    batch = make_batch(np.random.RandomState(0))
    jbatch = jax.tree.map(jnp.asarray, batch)
    with pytest.MonkeyPatch.context() as mp:
        class Trunk7x7(jax_det.ResNet50Trunk):
            s2d_stem: bool = False

        mp.setattr(jax_det, "ResNet50Trunk", Trunk7x7)
        model = jax_e2e.UnsupervisedEndToEnd(jcfg, class_to_symbolic=C2S, **TINY_DET)
        params = unbox(jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, jbatch)["params"])

        def loss_fn(p):
            out = model.apply({"params": p}, jbatch)
            return out["loss"], out

        value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        (_, out), grads = value_and_grad(params)
        detector = jax_det.SimpleDetector(final_dim=512, semantic=False, dtype=jnp.float32, **TINY_DET)
        logits = jax.jit(lambda p: detector.apply({"params": p}, jbatch["images"], jbatch["boxes"],
                                                  jbatch["box_mask"])["obj_logits"])(params["detector"])
        tx = jax_optimizer(JaxOptimizerConfig(**OPT))
        update = jax.jit(tx.update)
        p, state, trajectory = params, tx.init(params), []
        for _ in range(STEPS):
            (_, o), g = value_and_grad(p)
            trajectory.append({k: float(o[k]) for k in ("loss",) + LOSSES})
            updates, state = update(g, state, p)
            p = jax.tree.map(lambda a, u: a + u, p, updates)
    return dict(batch=batch, params=jax.device_get(params), out=jax.device_get(out), grads=jax.device_get(grads),
                logits=np.asarray(logits), trajectory=trajectory)


def port_model(params, **kw):
    _, tcfg = configs()
    return load_state(UnsupervisedEndToEnd(tcfg, class_to_symbolic=C2S, **TINY_DET, **kw), port_state(params))


def test_forward_losses_and_every_gradient_match_jax(jax_side):
    model = port_model(jax_side["params"])
    out = model(to_device(jax_side["batch"], "cpu"))
    out["loss"].backward()
    want = {k: v for k, v in jax_side["out"].items() if v is not None}
    assert out["cnn_aux_loss"] is None and "cnn_aux_loss" not in want
    assert set(out) - {"cnn_aux_loss"} == set(want)
    assert set(LOSSES) <= set(out)
    for k, v in want.items():
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(v), atol=ATOL, rtol=RTOL, err_msg=k)
    grads = port_state(jax_side["grads"])
    names = dict(model.named_parameters())
    for name, p in names.items():
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(grads[name])
        scale = float(np.abs(grads[name]).max())
        np.testing.assert_allclose(got, grads[name], atol=ATOL + RTOL * scale, rtol=0, err_msg=name)
    # the detector trains end to end; its unused head gets no gradient
    assert names["detector.conv1.weight"].grad.abs().sum() > 0
    assert names["detector.obj_downsample.weight"].grad is None and not grads["detector.obj_downsample.weight"].any()


def test_predicted_classes_equal_and_no_near_tie(jax_side):
    """The tags and object labels come from an argmax over 81 logits that
    the two frameworks compute to ~1e-6: both must pick the same class, and
    each box's top-two margin must exceed the logits' tolerance."""
    model = port_model(jax_side["params"])
    b = to_device(jax_side["batch"], "cpu")
    with torch.no_grad():
        logits = model.detector(b["images"], b["boxes"], b["box_mask"])["obj_logits"].numpy()
    want = jax_side["logits"]
    np.testing.assert_allclose(logits, want, atol=ATOL, rtol=RTOL)
    assert np.abs(want).max() < 10
    np.testing.assert_array_equal(logits.argmax(-1), want.argmax(-1))
    top2 = np.sort(want, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    assert margin.min() > LOGIT_TOL, margin


def test_three_steps_follow_jax(jax_side):
    """Three BertAdam steps at lr 1e-3 with weight decay and the clip:
    every loss within 2e-4 at every step."""
    model = port_model(jax_side["params"])
    trainer = Trainer(model, OptimizerConfig(**OPT), TrainConfig(seed=0), device="cpu").init_state(init_weights=False)
    for want in jax_side["trajectory"]:
        got = trainer.train_step(jax_side["batch"])
        for k, v in want.items():
            assert float(got[k]) == pytest.approx(v, abs=TRAJ_TOL, rel=TRAJ_TOL), k
    # feat_loss regresses the detector's own features, which the updates
    # move: it rises in JAX's trajectory as in the port's
    feat = [t["feat_loss"] for t in jax_side["trajectory"]]
    assert feat[0] < feat[1] < feat[2]
    # the unused head is decayed while its gradient is zero
    w0 = torch.tensor(port_state(jax_side["params"])["detector.obj_downsample.weight"])
    assert not torch.equal(model.detector.obj_downsample.weight.detach(), w0)


def test_detached_targets_and_integer_inputs(jax_side):
    """What the model hands the trunk: the features keep their gradient
    unless ``train_detector`` is false; the targets, tags and labels carry
    none."""
    for train_detector in (True, False):
        model = port_model(jax_side["params"], train_detector=train_detector)
        seen = {}
        trunk_forward = model.trunk.forward

        def spy(sub, *args, **kw):
            seen.update(sub)
            return trunk_forward(sub, *args, **kw)

        model.trunk.forward = spy
        model(to_device(jax_side["batch"], "cpu"))["loss"].backward()
        assert seen["visual_feats"].requires_grad == train_detector
        for k in ("feat_target", "visual_tags", "obj_labels", "visual_tags_objective", "attr_labels"):
            assert not seen[k].requires_grad, k
        for k in ("visual_tags", "obj_labels", "visual_tags_objective"):
            assert not seen[k].is_floating_point(), k
        feat_mask, tag_mask = (torch.as_tensor(jax_side["batch"][k]) > 0 for k in ("feat_mask", "tag_mask"))
        assert not seen["visual_feats"][feat_mask].any() and (seen["visual_tags"][tag_mask] == 81 + 4 + 2).all()
        assert (seen["obj_labels"][~feat_mask] == -1).all() and (seen["attr_labels"] == -1).all()
        det_grads = [p.grad for n, p in model.named_parameters() if n.startswith("detector.")]
        if train_detector:
            trunk_grads = {n: p.grad for n, p in model.named_parameters() if n.startswith("trunk.")}
        else:
            assert all(g is None for g in det_grads)
            for n, p in model.named_parameters():  # the trunk's gradients do not depend on it
                if n.startswith("trunk."):
                    assert (p.grad is None) == (trunk_grads[n] is None), n
                    if p.grad is not None:
                        torch.testing.assert_close(p.grad, trunk_grads[n], atol=0, rtol=0)


def test_without_a_table_the_tags_are_the_classes(jax_side):
    """Without ``class_to_symbolic`` a tag is the predicted class itself
    (clipped to the symbolic vocabulary, which holds all 81 here)."""
    _, tcfg = configs()
    model = UnsupervisedEndToEnd(tcfg, **TINY_DET).init_weights(torch.Generator().manual_seed(0))
    seen = {}
    trunk_forward = model.trunk.forward
    model.trunk.forward = lambda sub, *a, **k: (seen.update(sub), trunk_forward(sub, *a, **k))[1]
    b = to_device(jax_side["batch"], "cpu")
    with torch.no_grad():
        out = model(b)
        pred = model.detector(b["images"], b["boxes"], b["box_mask"])["obj_logits"].argmax(-1)
    assert np.isfinite(float(out["loss"]))
    keep = b["tag_mask"] == 0
    assert torch.equal(seen["visual_tags"][keep], pred[keep])
    assert torch.equal(seen["obj_labels"][b["feat_mask"] > 0], pred[b["feat_mask"] > 0])


@pytest.mark.parametrize("no_decay", [(), ("bias", "layer_norm", "LayerNorm")], ids=["mask_only", "config_default"])
def test_decay_decision_equals_jax_on_every_parameter(jax_side, no_decay):
    """BertAdam's decision on each port parameter equals JAX's on its Flax
    leaf (``default_decay_mask``, then ``no_decay``): the trunk's through
    ``flax_path``, the detector's through ``detector_flax_path`` (FrozenBN
    scales and biases not decayed, means and vars decayed, kernels decayed)."""
    extra = tuple(s.lower() for s in no_decay)
    flat = {}
    for path, m in jax.tree_util.tree_flatten_with_path(default_decay_mask(jax_side["params"]))[0]:
        joined = "/".join(str(k.key) for k in path)
        flat[joined] = m and not any(s in joined.lower() for s in extra)
    _, tcfg = configs()
    model = UnsupervisedEndToEnd(tcfg, class_to_symbolic=C2S, **TINY_DET)
    opt = BertAdam(model.named_parameters(), OptimizerConfig(no_decay=no_decay), decay=model.decays)
    seen = set()
    for name in opt.params:
        module, rest = name.split(".", 1)
        path = f"{module}/" + (flax_path(rest) if module == "trunk" else detector_flax_path(rest))
        assert path in flat, (name, path)
        assert opt.decay[name] == flat[path], (name, path)
        seen.add(path)
    assert seen == set(flat)
    d = opt.decay
    assert d["detector.conv1.weight"] and d["detector.layer4.0.downsample.1.running_var"]
    assert not d["detector.layer1.0.bn2.weight"] and not d["detector.layer2.0.downsample.1.bias"]
    assert d["detector.obj_downsample.weight"] and not d["detector.regularizing_predictor.bias"]


def test_unsup_e2e_state_round_trips_through_the_jax_importers(jax_side):
    """JAX's importers take the port's state dict back to the Flax tree it
    came from, leaf for leaf: the detector part through
    ``convert_resnet50_state_dict`` (7 x 7 stem), the trunk through
    ``convert_lxrt_state_dict``."""
    jcfg, _ = configs()
    params = jax_side["params"]
    state = port_state(params)
    det = convert_resnet50_state_dict({k[len("detector."):]: v for k, v in state.items()
                                       if k.startswith("detector.")}, s2d_stem=False)
    trunk = convert_lxrt_state_dict({k[len("trunk."):]: v for k, v in state.items() if k.startswith("trunk.")}, jcfg)
    tree = {"detector": det, "trunk": trunk}
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))
    model = port_model(params)
    assert set(dict(model.named_parameters())) <= set(state)


def test_unsup_e2e_path_on_the_cpu():
    """tools/unsup_e2e_path.py at a small size: the config's geometry (36
    boxes, 30 text tokens), uint8 images, the joint masks, and finite train
    steps whose loss falls on the repeated batch."""
    from visualbert_torch.tools import unsup_e2e_path

    raw = unsup_e2e_path.config()
    assert raw["model"] == {"visual_embedding_dim": 2048, "use_flash_attention": True, "fast_dropout": True,
                            "fused_mlm_xent": True}
    raw["model"] = dict(raw["model"], hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=128, max_position_embeddings=64, vocab_size=200, dtype="float32")
    trainer, batch = unsup_e2e_path.build("cpu", batch=2, raw=raw, image_size=64, **TINY_DET)
    assert batch["images"].dtype == torch.uint8 and batch["images"].shape == (2, 64, 64, 3)
    assert batch["boxes"].shape == (2, 36, 4) and batch["input_ids"].shape == (2, 30)
    assert torch.equal(batch["feat_mask"], batch["tag_mask"])
    assert (batch["boxes"][..., 2:] > batch["boxes"][..., :2]).all() and (batch["boxes"] <= 63).all()
    torch.testing.assert_close(batch["boxes_norm"], batch["boxes"] / 64)
    assert trainer.model.ucfg.symbolic_vocab_size == 2003 and trainer.model.class_to_symbolic == C2S
    assert trainer.optimizer.cfg.schedule == "none"
    losses = [trainer.train_step(batch) for _ in range(3)]
    assert all(np.isfinite(float(m["loss"])) for m in losses) and set(LOSSES) <= set(losses[0])
    assert float(losses[-1]["loss"]) < float(losses[0]["loss"])
    host = unsup_e2e_path.synth_batch(32, 768, 36, 30)
    assert 0.10 < host["feat_mask"].mean() < 0.20 and (host["masked_lm_labels"] >= 0).mean() < 0.2
