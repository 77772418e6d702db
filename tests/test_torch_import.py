"""The import of reference torch checkpoints (``.th``/``.pth``/``.bin``) in
the port (tools/import_torch.py) against the JAX package's
``convert_state_dict`` -> ``maybe_special_initialize`` -> ``merge_into``,
the path of the JAX registry's ``_restore``, on the CPU.

A reference-layout state dict, built from another init than the model's,
loads into the port; every parameter must then equal what JAX's merge gives
its own init tree, seen through the weight bridge: exactly the leaves JAX
loads take the file's values, every other keeps the model's own. The
files carry ``module.`` prefixes, ``gamma``/``beta`` names, HF visual names,
the tied decoder, missing visual tables (copied from the text ones) and keys
no model has. The LXRT, LXRT-for-VQA and ResNet50 converters equal JAX's
leaf for leaf."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.models import unsupervised as jax_unsup
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.tools import import_torch as jax_import
from visualbert_tpu.tools.export_torch import export_resnet50_state_dict, export_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_torch.config import VisualBertConfig
from visualbert_torch.models import unsupervised as unsup
from visualbert_torch.models.vcr import VisualBertDetectorModel
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.tools import import_torch
from visualbert_torch.tools.weights import flickr_attention_state, load_state, unsupervised_state
from test_torch_detector import TINY_DET, jax_7x7_stem  # noqa: F401 (a fixture)
from test_torch_flickr import head_batch as flickr_batch
from test_torch_model import make_batch
from test_torch_nlvr2 import head_batch as nlvr_batch
from test_torch_unsupervised import configs as unsup_configs
from test_torch_unsupervised import jax_params as unsup_jax_params
from test_torch_vcr import detector_batch, multichoice_batch
from test_torch_vqa import head_batch as vqa_batch
from test_torch_vqa_advanced import TINY

HEADS = {"pretraining": {}, "vqa": {"num_answers": 7}, "vqa_advanced": {}, "nlvr": {}, "flickr": {},
         "multichoice": {}}


def head_batch(head):
    """A batch that reaches every parameter of the head's JAX init."""
    rng = np.random.RandomState(0)
    if head in ("pretraining", "vqa_advanced"):
        batch = make_batch(rng)
        batch["input_ids"] %= TINY["vocab_size"]
        batch["masked_lm_labels"] = np.where(batch["masked_lm_labels"] >= 0,
                                             batch["masked_lm_labels"] % TINY["vocab_size"], -1)
        batch["visual_embeddings"] = rng.randn(*batch["image_mask"].shape, TINY["visual_embedding_dim"]).astype(
            np.float32)
        return batch
    return {"vqa": lambda: vqa_batch(rng, HEADS["vqa"]["num_answers"]), "nlvr": lambda: nlvr_batch(rng),
            "flickr": lambda: flickr_batch(rng), "multichoice": lambda: multichoice_batch(rng)}[head]()


@functools.lru_cache(maxsize=None)
def jax_task(head, seed):
    jcfg = JaxConfig(**TINY, dtype=jnp.float32)
    batch = head_batch(head)
    model = JaxTask(jcfg, head_type=head, **HEADS[head])
    return jcfg, unbox(model.init(jax.random.PRNGKey(seed), jax.tree.map(jnp.asarray, batch))["params"])


def port_names(params, jcfg):
    """A VisualBertForTask tree in the port's names (the weight bridge)."""
    sd = export_state_dict(params, jcfg)
    if "flickr_attention" in params:
        sd.update(flickr_attention_state(params["flickr_attention"]))
    return sd


def reference_file(state, case):
    """A reference-layout state dict of ``state`` (port names) as the
    reference code, HF or a DataParallel wrapper saved it."""
    out = {}
    for k, v in state.items():
        if case == "module_gamma_beta":
            k = "module." + re.sub(r"LayerNorm\.weight$", "LayerNorm.gamma", re.sub(r"LayerNorm\.bias$",
                                                                                   "LayerNorm.beta", k))
        elif case == "hf_names":
            k = (k.replace("embeddings.projection.", "embeddings.visual_projection.")
                 .replace("embeddings.token_type_embeddings_visual.", "embeddings.visual_token_type_embeddings.")
                 .replace("embeddings.position_embeddings_visual.", "embeddings.visual_position_embeddings."))
        elif case == "no_visual_tables" and ("_embeddings_visual." in k):
            continue
        elif case == "no_bert_prefix":
            k = k[len("bert."):] if k.startswith("bert.") else k
        elif case == "encoder_only" and not k.startswith("bert.encoder."):
            continue
        out[k] = torch.tensor(v)
    out["bert.embeddings.position_ids"] = torch.arange(8)[None]  # a buffer no model parameter matches
    out["some_other_head.weight"] = torch.ones(3, 3)
    return out


CASES = ["module_gamma_beta", "hf_names", "no_visual_tables", "no_bert_prefix", "encoder_only"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("head", sorted(HEADS))
def test_restore_loads_exactly_what_jax_loads(tmp_path, head, case):
    jcfg, init = jax_task(head, seed=0)
    _, other = jax_task(head, seed=1)
    path = str(tmp_path / "ref.th")
    torch.save(reference_file(port_names(other, jcfg), case), path)

    flat = jax_import.load_torch_file(path)
    loaded = jax_import.maybe_special_initialize(jax_import.convert_state_dict(flat, jcfg))
    want = port_names(jax.device_get(jax_import.merge_into(init, loaded)), jcfg)

    tcfg = VisualBertConfig(**TINY, dtype=torch.float32)
    model = load_state(VisualBertForTask(tcfg, head, **HEADS[head]), port_names(init, jcfg))
    replaced = import_torch.restore_torch_file(model, path, tcfg)
    assert replaced
    got = model.state_dict()
    assert set(got) == set(want)
    init_sd, other_sd = port_names(init, jcfg), port_names(other, jcfg)
    n_loaded = 0
    for name, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[name], err_msg=name)
        n_loaded += not np.array_equal(want[name], init_sd[name])
    assert 0 < n_loaded < len(got)
    if case == "no_visual_tables":  # the text tables, copied
        np.testing.assert_array_equal(got["bert.embeddings.position_embeddings_visual.weight"].numpy(),
                                      other_sd["bert.embeddings.position_embeddings.weight"])
    if case == "encoder_only":
        np.testing.assert_array_equal(got["bert.embeddings.word_embeddings.weight"].numpy(),
                                      init_sd["bert.embeddings.word_embeddings.weight"])


def test_a_shape_mismatch_raises_as_jax(tmp_path):
    jcfg, init = jax_task("vqa", seed=0)
    sd = {k: torch.tensor(v) for k, v in port_names(init, jcfg).items()}
    sd["classifier.weight"] = torch.zeros(9, TINY["hidden_size"])
    sd["classifier.bias"] = torch.zeros(9)
    path = str(tmp_path / "bad.pth")
    torch.save({"model": sd}, path)
    loaded = jax_import.convert_state_dict(jax_import.load_torch_file(path), jcfg)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_import.merge_into(init, loaded)
    tcfg = VisualBertConfig(**TINY, dtype=torch.float32)
    model = VisualBertForTask(tcfg, "vqa", num_answers=7)
    with pytest.raises(ValueError, match="shape mismatch"):
        import_torch.restore_torch_file(model, path, tcfg)


def test_model_trees_are_the_jax_trees():
    """The port's models in the Flax layout have the JAX init trees' leaves,
    shapes included, for every family the registry builds (the detector
    model's as JAX's converters lay out its two parts)."""
    for head in sorted(HEADS):
        jcfg, init = jax_task(head, seed=0)
        model = load_state(VisualBertForTask(VisualBertConfig(**TINY, dtype=torch.float32), head, **HEADS[head]),
                           port_names(init, jcfg))
        assert_same_tree(import_torch.model_tree(model), init)
    # the detector model: its two parts through JAX's own converters
    jcfg = JaxConfig(**TINY, dtype=jnp.float32)
    model = VisualBertDetectorModel(VisualBertConfig(**TINY, dtype=torch.float32), final_dim=16, **TINY_DET)
    model.init_weights(torch.Generator().manual_seed(0))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    part = {p: {k[len(p):]: v for k, v in state.items() if k.startswith(p)} for p in ("bert.", "detector.")}
    assert_same_tree(import_torch.model_tree(model),
                     {"bert": jax_import.convert_state_dict(part["bert."], jcfg),
                      "detector": jax_import.convert_resnet50_state_dict(part["detector."], s2d_stem=False)})
    for cls in ("UnsupervisedVisualBert", "UnsupervisedVQAModel"):
        jucfg, tucfg = unsup_configs()
        params = unsup_jax_params(getattr(jax_unsup, cls)(jucfg))
        model = load_state(getattr(unsup, cls)(tucfg), unsupervised_state(params))
        assert_same_tree(import_torch.model_tree(model), params)


def assert_same_tree(got, want):
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(leaf), err_msg=str(path))


def test_nothing_lands_in_the_detector_and_unsupervised_models(tmp_path):
    """A VisualBERT file shares no top-level key with these trees, in JAX
    as in the port: nothing loads (ROADMAP.md C10)."""
    jcfg, other = jax_task("pretraining", seed=1)
    path = str(tmp_path / "ref.th")
    torch.save(reference_file(port_names(other, jcfg), "module_gamma_beta"), path)
    loaded = jax_import.maybe_special_initialize(jax_import.convert_state_dict(jax_import.load_torch_file(path), jcfg))
    tcfg = VisualBertConfig(**TINY, dtype=torch.float32)
    _, tucfg = unsup_configs()
    for model in (VisualBertDetectorModel(tcfg, final_dim=16, **TINY_DET), unsup.UnsupervisedVisualBert(tucfg),
                  unsup.UnsupervisedVQAModel(tucfg)):
        model.init_weights(torch.Generator().manual_seed(0))
        tree = import_torch.model_tree(model)
        assert jax.tree.leaves(jax_import.merge_into(tree, loaded)) is not None
        before = {k: v.clone() for k, v in model.state_dict().items()}
        assert import_torch.restore_torch_file(model, path, tcfg) == []
        for k, v in model.state_dict().items():
            assert torch.equal(v, before[k]), k


def test_lxrt_converters_equal_jax():
    """An LXRT checkpoint (``module.``, ``gamma``/``beta``, a fine-tuned
    VQAModel's bare ``logit_fc``) through both packages' converters, and
    the answer-head surgery onto another answer table."""
    from visualbert_tpu.data.answer_table import AnswerTable as JaxAnswerTable

    jucfg, tucfg = unsup_configs(task_qa=True)
    params = unsup_jax_params(jax_unsup.UnsupervisedVisualBert(jucfg))
    flat = {}
    for k, v in unsupervised_state(params).items():
        k = re.sub(r"LayerNorm\.weight$", "LayerNorm.gamma", k)
        k = k.replace("answer_head.logit_fc", "logit_fc")
        flat["module." + k] = v
    assert_same_tree(import_torch.convert_lxrt_state_dict(flat, tucfg),
                     jax_import.convert_lxrt_state_dict(flat, jucfg))
    vqa_init = unsup_jax_params(jax_unsup.UnsupervisedVQAModel(jucfg))
    src = ["a0", "red", "Two", "dog", "a4", "x", "y", "z"]
    dst = ["dog", "cat", "two", "red", "q", "w", "e", "r"]
    got, n = import_torch.convert_lxrt_for_vqa(flat, tucfg, jax.device_get(vqa_init), src, dst)
    want, n_want = jax_import.convert_lxrt_for_vqa(flat, jucfg, vqa_init, JaxAnswerTable(src), JaxAnswerTable(dst))
    assert n == n_want == 3
    assert_same_tree(got, want)
    bare, n0 = import_torch.convert_lxrt_for_vqa(flat, tucfg, vqa_init)
    assert n0 == 0 and "fc2" not in bare["answer_head"] and "fc1" in bare["answer_head"]


def test_resnet50_converter_and_its_inverse_equal_jax(jax_7x7_stem):
    """A reference SimpleDetector checkpoint (its Sequential names) through
    both converters (7 x 7 stem), and the port's inverse against JAX's
    ``export_resnet50_state_dict``. With the whole model's ``detector.``
    prefix left on, both converters rename nothing of the trunk: the prefix
    is stripped after the Sequential renames (ROADMAP.md C11)."""
    from visualbert_tpu.models import detector as jax_det

    jd = jax_det.SimpleDetector(final_dim=16, dtype=jnp.float32, **TINY_DET)
    b = detector_batch(np.random.RandomState(0))
    args = [jnp.asarray(b[k]) for k in ("images", "boxes", "box_mask", "classes", "segms")]
    params = unbox(jd.init(jax.random.PRNGKey(3), *args)["params"])
    state = export_resnet50_state_dict(params)
    renames = [(r"^conv1\.", "backbone.0."), (r"^bn1\.", "backbone.1."), (r"^layer1\.", "backbone.4."),
               (r"^layer2\.", "backbone.5."), (r"^layer3\.", "backbone.6."), (r"^layer4\.", "after_roi_align.0."),
               (r"^obj_downsample\.", "obj_downsample.1.")]
    flat = {}
    for k, v in state.items():
        for pat, rep in renames:
            k = re.sub(pat, rep, k)
        flat[k] = v
    tree = import_torch.convert_resnet50_state_dict(flat)
    assert_same_tree(tree, jax_import.convert_resnet50_state_dict(flat, s2d_stem=False))
    assert_same_tree(tree, params)
    prefixed = {"detector." + k: v for k, v in flat.items()}
    partial = import_torch.convert_resnet50_state_dict(prefixed)
    assert_same_tree(partial, jax_import.convert_resnet50_state_dict(prefixed, s2d_stem=False))
    assert "backbone" not in partial and "regularizing_predictor" in partial
    back = import_torch.resnet50_state(tree)
    assert set(back) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
