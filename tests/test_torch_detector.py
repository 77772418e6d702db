"""The detector of the port (utils/boxes.py, utils/images.py,
ops/roi_align.py, models/detector.py, tools/extract_features.py) against
the JAX package, on the CPU.

``make_mask``, the box helpers, ``prepare_image`` and ``ImageFolderStore``
equal the JAX functions bit for bit on a JPEG and a metadata file written
here with PIL. ``roi_align`` (both implementations, sampling ratio 0 and 2,
boxes inside the map, on its border and degenerate) and its gradient with
respect to the features agree with JAX's in fp32 at atol 2e-5 / rtol 1e-4,
as do ``FrozenBatchNorm``, layer4, ``SimpleDetector`` (uint8 images with
their content smaller than the canvas and fp32 images; with masks and
classes and without) and every parameter gradient, the batch norms' means
and vars among them. The trunk with its 7 x 7 stem is held against the JAX
trunk with its space-to-depth stem, which sums the same products in another
order, at atol 1e-4 / rtol 1e-4 (the JAX package holds its two stems
within 1e-5 of each other, tests/test_resnet_import.py), and against the
JAX trunk with the 7 x 7 stem at atol 2e-5 / rtol 1e-4. The detector and
model comparisons run the JAX detector with its 7 x 7 stem
(``jax_7x7_stem``): through the s2d stem the forward agrees within 2e-5,
but a few ReLUs whose inputs sit within rounding of 0 flip, and gradients
then differ by up to 1e-3 of their largest entry.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.models import detector as jax_det
from visualbert_tpu.ops.roi_align import roi_align as jax_roi_align
from visualbert_tpu.tools import extract_features as jax_extract
from visualbert_tpu.tools.export_torch import export_resnet50_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_tpu.utils import boxes as jax_boxes
from visualbert_tpu.utils import images as jax_images
from visualbert_torch.models import detector
from visualbert_torch.ops.roi_align import roi_align
from visualbert_torch.tools.extract_features import extract_to_folder
from visualbert_torch.tools.weights import load_state
from visualbert_torch.utils import boxes, images

ATOL, RTOL = 2e-5, 1e-4
TRUNK_TOL = 1e-4  # the 7 x 7 stem against the s2d stem: another summation order
TINY_DET = dict(trunk_blocks=(1, 1, 1), layer4_blocks=1, width_div=4)


@pytest.fixture
def jax_7x7_stem(monkeypatch):
    """The JAX detector's trunk with ``s2d_stem=False``: the 7 x 7 stem."""

    class Trunk7x7(jax_det.ResNet50Trunk):
        s2d_stem: bool = False

    monkeypatch.setattr(jax_det, "ResNet50Trunk", Trunk7x7)


def perturbed(params, seed=1, scale=0.05):
    """Flax params with every leaf moved by seeded noise: batch-norm
    statistics away from identity (vars stay positive)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda x: x + scale * jnp.asarray(rng.randn(*x.shape), x.dtype), params)


def test_box_helpers_match_jax():
    for h, w in ((480, 640), (1080, 1920), (768, 300), (17, 17)):
        assert boxes.resize_plan(h, w) == jax_boxes.resize_plan(h, w)
        assert boxes.resize_plan(h, w, 512) == jax_boxes.resize_plan(h, w, 512)
    bx = np.array([[-4.0, 3.0, 700.5, 90.0], [10.0, -1.0, 20.0, 500.0]], np.float32)
    np.testing.assert_array_equal(boxes.scale_boxes(bx, 0.4), jax_boxes.scale_boxes(bx, 0.4))
    np.testing.assert_array_equal(boxes.clip_boxes(bx, 480, 640), jax_boxes.clip_boxes(bx, 480, 640))


@pytest.mark.parametrize("case", ["triangle", "concave_pair", "degenerate", "thin_box"])
def test_make_mask_matches_jax(case):
    polys, box = {
        "triangle": ([np.array([10, 10, 40, 12, 20, 45])], [5, 5, 50, 50]),
        "concave_pair": ([np.array([0, 0, 30, 0, 30, 30, 15, 10, 0, 30]), np.array([[32, 32], [40, 33], [36, 44]])],
                         [0, 0, 44, 44]),
        "degenerate": ([np.array([3, 3, 9, 9])], [0, 0, 12, 12]),  # two vertices: no area
        "thin_box": ([np.array([0, 0, 100, 0, 100, 100, 0, 100])], [20, 20, 20, 60]),  # zero width
    }[case]
    got = boxes.make_mask(polys, box)
    assert got.shape == (14, 14) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_boxes.make_mask(polys, box))
    np.testing.assert_array_equal(boxes.make_mask(polys, box, 7, 2), jax_boxes.make_mask(polys, box, 7, 2))


def write_image(folder, image_id, h=120, w=200):
    """A JPEG written with PIL and the VCR-style metadata beside it."""
    from PIL import Image

    rng = np.random.RandomState(7)
    pixels = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    Image.fromarray(pixels).save(os.path.join(folder, f"{image_id}.jpg"), quality=90)
    meta = {"boxes": [[10, 12, 90, 100, 0.9], [120, 5, 199, 119, 0.8], [0, 0, 30, 30, 0.5]],
            "names": ["person", "car", "unknown"],
            "segms": [[[12, 14, 80, 20, 60, 95]], [[125, 10, 190, 10, 190, 110, 125, 110]], []]}
    with open(os.path.join(folder, f"{image_id}.json"), "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("device_normalize", [True, False], ids=["uint8", "fp32"])
@pytest.mark.parametrize("draft", [True, False], ids=["draft", "full_decode"])
def test_prepare_image_and_store_match_jax(tmp_path, device_normalize, draft):
    write_image(tmp_path, "img0")
    path = str(tmp_path / "img0.jpg")
    for target in (64, 96):
        got = images.prepare_image(path, target, normalize=not device_normalize, draft=draft)
        want = jax_images.prepare_image(path, target, normalize=not device_normalize, draft=draft)
        assert set(got) == set(want)
        for k in got:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    names = ["__background__", "person", "car"]
    ours = images.ImageFolderStore(str(tmp_path), target=64, class_names=names, device_normalize=device_normalize,
                                   draft=draft)
    theirs = jax_images.ImageFolderStore(str(tmp_path), target=64, class_names=names,
                                         device_normalize=device_normalize, draft=draft)
    assert "img0" in ours and "nope" not in ours
    got, want = ours.get("img0"), theirs.get("img0")
    assert set(got) == set(want) and got["image"].dtype == (np.uint8 if device_normalize else np.float32)
    for k in got:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert list(got["classes"]) == [1, 2, 0] and got["segms"].shape == (3, 14, 14)
    wire, wire_j = images.image_wire_fields(got), jax_images.image_wire_fields(want)
    for k in wire:
        assert wire[k].dtype == wire_j[k].dtype and wire[k].tobytes() == wire_j[k].tobytes(), k
    np.testing.assert_array_equal(images.normalize_image(got["image"].astype(np.uint8)),
                                  jax_images.normalize_image(want["image"].astype(np.uint8)))


def test_reading_images_without_pil_names_it(tmp_path, monkeypatch):
    write_image(tmp_path, "img0")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        images.ImageFolderStore(str(tmp_path)).get("img0")
    with pytest.raises(ImportError, match="PIL"):
        images.load_image(str(tmp_path / "img0.jpg"))


def roi_inputs():
    """A [2, 13, 11, 6] feature map (NHWC) of 208 x 176 images at 1/16 and
    4 boxes an image: inside, on the border, degenerate, beyond the image."""
    rng = np.random.RandomState(3)
    fm = rng.randn(2, 13, 11, 6).astype(np.float32)
    bx = np.array([
        [[20.0, 30.0, 120.0, 150.0], [0.0, 0.0, 175.0, 207.0], [50.0, 60.0, 50.0, 60.0], [150.0, 190.0, 260.0, 300.0]],
        [[5.5, 7.25, 40.0, 33.0], [100.0, 0.0, 175.0, 40.0], [10.0, 10.0, 10.5, 200.0], [-20.0, -5.0, 30.0, 30.0]],
    ], np.float32)
    return fm, bx


@pytest.mark.parametrize("sampling_ratio", [0, 2])
@pytest.mark.parametrize("implementation", ["matmul", "gather"])
def test_roi_align_matches_jax(implementation, sampling_ratio):
    fm, bx = roi_inputs()
    cot = np.random.RandomState(4).randn(2, 4, 7, 7, 6).astype(np.float32)

    def jax_fn(f):
        out = jax_roi_align(f, jnp.asarray(bx), 7, sampling_ratio, 1 / 16, 8, implementation)
        return (out * cot).sum(), out

    (_, want), dfm = jax.value_and_grad(jax_fn, has_aux=True)(jnp.asarray(fm))
    x = torch.tensor(fm.transpose(0, 3, 1, 2), requires_grad=True)
    got = roi_align(x, torch.tensor(bx), 7, sampling_ratio, 1 / 16, 8, implementation)
    assert got.shape == (2, 4, 6, 7, 7) and got.dtype == torch.float32
    (got * torch.tensor(cot.transpose(0, 1, 4, 2, 3))).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want).transpose(0, 1, 4, 2, 3), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dfm).transpose(0, 3, 1, 2), atol=ATOL, rtol=RTOL)


def test_roi_align_implementations_agree_in_bf16():
    """Both forms cast back to the features' dtype; bf16 features give the
    same numbers through either within a bf16 ulp."""
    fm, bx = roi_inputs()
    x = torch.tensor(fm.transpose(0, 3, 1, 2)).bfloat16()
    a = roi_align(x, torch.tensor(bx), implementation="matmul")
    b = roi_align(x, torch.tensor(bx), implementation="gather")
    assert a.dtype == b.dtype == torch.bfloat16
    torch.testing.assert_close(a.float(), b.float(), atol=2e-2, rtol=1e-2)
    with pytest.raises(ValueError, match="implementation"):
        roi_align(x, torch.tensor(bx), implementation="loop")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_batch_norm_matches_jax(dtype):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 4, 3).astype(np.float32)  # NHWC
    p = {"scale": rng.randn(3).astype(np.float32), "bias": rng.randn(3).astype(np.float32),
         "mean": rng.randn(3).astype(np.float32), "var": rng.rand(3).astype(np.float32) + 0.5}
    want = jax_det.FrozenBatchNorm(3, getattr(jnp, dtype)).apply({"params": p}, jnp.asarray(x, getattr(jnp, dtype)))
    bn = detector.FrozenBatchNorm(3, getattr(torch, dtype))
    load_state(bn, {"weight": p["scale"], "bias": p["bias"], "running_mean": p["mean"], "running_var": p["var"]})
    assert sorted(n for n, _ in bn.named_parameters()) == ["bias", "running_mean", "running_var", "weight"]
    got = bn(torch.tensor(x.transpose(0, 3, 1, 2)).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().detach().numpy(), np.asarray(want, np.float32).transpose(0, 3, 1, 2),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("s2d_stem,tol", [(True, (TRUNK_TOL, TRUNK_TOL)), (False, (ATOL, RTOL))],
                         ids=["s2d_stem", "7x7_stem"])
def test_trunk_matches_jax_trunk(s2d_stem, tol):
    """The port's 7 x 7 trunk against the JAX trunk with its default
    space-to-depth stem (exported to the 7 x 7 kernel) and with the 7 x 7."""
    blocks = (2, 1, 2)
    img = np.random.RandomState(6).randn(2, 64, 48, 3).astype(np.float32)
    jt = jax_det.ResNet50Trunk(jnp.float32, blocks, width_div=4, s2d_stem=s2d_stem)
    params = perturbed(unbox(jt.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"]))
    assert params["conv1"]["kernel"].shape[:2] == ((4, 4) if s2d_stem else (7, 7))
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(img)))
    trunk = load_state(detector.ResNet50Trunk(torch.float32, blocks, width_div=4), export_resnet50_state_dict(params))
    got = trunk(torch.tensor(img.transpose(0, 3, 1, 2))).detach().numpy()
    assert got.shape == (2, 256, 4, 3)
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=tol[0], rtol=tol[1])


def test_layer4_matches_jax():
    x = np.random.RandomState(8).randn(3, 7, 7, 256).astype(np.float32)
    jl = jax_det.ResNet50Layer4(jnp.float32, blocks=2, width_div=4)
    params = perturbed(unbox(jl.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]))
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(x)))
    sd = export_resnet50_state_dict({"after_roi_align": params})
    layer4 = load_state(detector.resnet50_layer4(torch.float32, 2, 4), {k[len("layer4."):]: v for k, v in sd.items()})
    got = layer4(torch.tensor(x.transpose(0, 3, 1, 2))).detach().numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=ATOL, rtol=RTOL)


def detector_inputs(uint8):
    rng = np.random.RandomState(9)
    B, N, S = 2, 4, 64
    if uint8:
        img = rng.randint(0, 256, (B, S, S, 3)).astype(np.uint8)
    else:
        img = rng.randn(B, S, S, 3).astype(np.float32)
    bx = np.array([[[2, 3, 40, 30], [10, 12, 60, 63], [0, 0, 63, 63], [5, 5, 5, 5]],
                   [[20, 4, 44, 50], [30, 30, 70, 80], [1, 1, 9, 9], [0, 0, 0, 0]]], np.float32)
    return {
        "images": img,
        "boxes": bx,
        "box_mask": np.array([[1, 1, 1, 0], [1, 1, 1, 1]], np.int32),
        "classes": rng.randint(0, 81, (B, N)).astype(np.int32),
        "segms": rng.rand(B, N, 14, 14).astype(np.float32),
        "image_hw": np.array([[50, 64], [64, 37]], np.int32),
    }


@pytest.mark.parametrize("case", ["uint8_masks_classes", "fp32_classes", "fp32_plain"])
def test_simple_detector_matches_jax(case, jax_7x7_stem):
    """Outputs and every parameter gradient of a scalar of all outputs.
    Without masks the JAX detector has no ``mask_upsample`` (Flax makes
    parameters at their first use): the port's takes seeded weights and
    gets no gradient."""
    inputs = detector_inputs(case.startswith("uint8"))
    semantic = case != "fp32_plain"
    if case != "uint8_masks_classes":
        inputs.pop("segms"), inputs.pop("image_hw")
    if not semantic:
        inputs.pop("classes")
    jd = jax_det.SimpleDetector(final_dim=16, semantic=semantic, dtype=jnp.float32, **TINY_DET)
    args = (inputs["images"], inputs["boxes"], inputs["box_mask"], inputs.get("classes"), inputs.get("segms"))
    jargs = tuple(None if a is None else jnp.asarray(a) for a in args)
    hw = None if "image_hw" not in inputs else jnp.asarray(inputs["image_hw"])
    params = perturbed(unbox(jd.init(jax.random.PRNGKey(2), *jargs, image_hw=hw)["params"]))
    rng = np.random.RandomState(10)
    c_reps, c_logits = rng.randn(2, 4, 16).astype(np.float32), rng.randn(2, 4, 81).astype(np.float32)

    def scalar(out, xp):
        s = (out["obj_reps"] * xp(c_reps)).sum() + (out["obj_logits"] * xp(c_logits)).sum()
        return s + out["cnn_regularization_loss"] if "cnn_regularization_loss" in out else s

    def jax_fn(p):
        out = jd.apply({"params": p}, *jargs, image_hw=hw)
        return scalar(out, jnp.asarray), out

    (_, want), grads = jax.value_and_grad(jax_fn, has_aux=True)(params)
    det = detector.SimpleDetector(final_dim=16, semantic=semantic, dtype=torch.float32, **TINY_DET)
    state = export_resnet50_state_dict(params)
    unused = {}
    if semantic and "segms" not in inputs:
        unused = {k: rng.randn(*v.shape).astype(np.float32) for k, v in det.state_dict().items()
                  if k.startswith("mask_upsample.")}
    det = load_state(det, {**state, **unused})
    targs = [None if a is None else torch.tensor(a) for a in args]
    out = det(*targs, image_hw=None if hw is None else torch.tensor(inputs["image_hw"]))
    scalar(out, torch.tensor).backward()
    assert set(out) == set(want)
    for k in want:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(want[k]), atol=ATOL, rtol=RTOL, err_msg=k)
    expect = export_resnet50_state_dict(grads)
    names = dict(det.named_parameters())
    assert set(names) == set(expect) | set(unused)
    for k in unused:
        assert names.pop(k).grad is None
    assert any(n.endswith("running_var") for n in names)  # the batch norms' statistics are trained (C8)
    for name, p in names.items():
        np.testing.assert_allclose(p.grad.numpy(), expect[name], atol=ATOL, rtol=RTOL, err_msg=name)


def test_uint8_images_are_normalized_and_rezeroed():
    """A uint8 canvas equals the host-normalized canvas with zeros outside
    the content extent."""
    inputs = detector_inputs(True)
    det = detector.SimpleDetector(final_dim=16, dtype=torch.float32, **TINY_DET).init_weights(
        torch.Generator().manual_seed(0))
    img, hw = inputs["images"], inputs["image_hw"]
    host = np.zeros(img.shape, np.float32)
    for b, (h, w) in enumerate(hw):
        host[b, :h, :w] = images.normalize_image(img[b, :h, :w])
    args = [torch.tensor(inputs[k]) for k in ("boxes", "box_mask", "classes", "segms")]
    with torch.no_grad():
        a = det(torch.tensor(img), *args, image_hw=torch.tensor(hw))
        b = det(torch.tensor(host), *args)
    for k in a:
        torch.testing.assert_close(a[k], b[k], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="classes"):
        det(torch.tensor(host), args[0], args[1])


def test_detector_dropout_repeats_from_its_seed():
    inputs = detector_inputs(False)
    det = detector.SimpleDetector(final_dim=16, dtype=torch.float32, dropout_rate=0.5, **TINY_DET).init_weights(
        torch.Generator().manual_seed(0))
    args = [torch.tensor(inputs[k]) for k in ("images", "boxes", "box_mask", "classes")]
    with torch.no_grad():
        off = det(*args)["obj_reps"]
        a, b, c = (det(*args, generator=torch.Generator().manual_seed(s))["obj_reps"] for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, off)
    det.dropout_rate = 0.0
    with torch.no_grad():
        assert torch.equal(det(*args, generator=torch.Generator().manual_seed(1))["obj_reps"], off)


def test_extract_to_folder_matches_jax(tmp_path, monkeypatch, jax_7x7_stem):
    class TinyDetector(jax_det.SimpleDetector):
        dtype: object = jnp.float32
        trunk_blocks: tuple = (1, 1, 1)
        layer4_blocks: int = 1
        width_div: int = 4

    rng = np.random.RandomState(11)
    items = [(f"im{i}", rng.randn(h, w, 3).astype(np.float32),
              np.array([[2, 2, 20, 25], [5, 1, w - 1, h - 1], [0, 0, 8, 8]], np.float32)[: n])
             for i, (h, w, n) in enumerate(((50, 70, 3), (64, 40, 2), (30, 30, 1)))]
    jd = TinyDetector(final_dim=16, semantic=False)
    params = perturbed(unbox(jd.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 4, 4)),
                                     jnp.ones((1, 4), jnp.int32))["params"]))
    monkeypatch.setattr(jax_det, "SimpleDetector", TinyDetector)
    kw = dict(final_dim=16, batch_size=2, image_size=64, max_boxes=4)
    assert jax_extract.extract_to_folder(items, str(tmp_path / "jax"), params=params, **kw) == 3
    det = load_state(detector.SimpleDetector(final_dim=16, semantic=False, dtype=torch.float32, **TINY_DET),
                     export_resnet50_state_dict(params))
    kw.pop("final_dim")
    assert extract_to_folder(items, str(tmp_path / "torch"), det, device="cpu", **kw) == 3
    for image_id, _, bx in items:
        got = np.load(tmp_path / "torch" / f"{image_id}.npy")
        want = np.load(tmp_path / "jax" / f"{image_id}.npy")
        assert got.shape == want.shape == (len(bx), 512) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
