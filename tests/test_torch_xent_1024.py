"""K5/K6 at width 1024 (bert-large's) on the 1024 form, without a card.

``csrc/mlm_xent.cu::xent_h1024_bwd_kernel`` runs K5 and K6 at width 1024 (and
every bf16/fp16 width from 769 up, zero-padded onto it) in thread-block
clusters of two blocks of 512 columns that form each streamed tile's logits
once (two N x V x 1024 products). Here, on the CPU:

* the plans (``ops/mlm_xent.py::wide_dx_plan`` / ``wide_de_plan`` at the
  1024 form's tiling) walked as the kernel walks them: every resident row
  block, vocabulary tile and column exactly once, no split empty;
* the constants of the source that the plans and these tests assume;
* the kernel's order of sums, emulated in torch (each 64-column panel's
  products in fp32, the panels of a block's 512 columns added in order,
  the two blocks' sums, then the bias; dlog rounded to the element type;
  the product tile by tile, K5's vocabulary splits summed in order, then
  g), held against the JAX package's backward kernels in interpret mode
  and against the port's plain versions;
* the launches against the entry points' signatures with a recording
  library, and the wrapper raising where no cluster fits;
* a ``VisualBertForTask("pretraining")`` at ``large()``'s widths (one
  layer, a small vocabulary) with ``fused_mlm_xent`` against the JAX model.

The kernel itself runs in ``tests/test_torch_xent_1024_cuda.py`` on the card.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.config import VisualBertConfig as JaxConfig
from visualbert_tpu.models.visualbert import VisualBertForTask as JaxTask
from visualbert_tpu.ops import mlm_xent as jax_xent
from visualbert_tpu.tools.export_torch import export_state_dict
from visualbert_tpu.train.trainer import unbox
from visualbert_torch.config import VisualBertConfig
from visualbert_torch.models.visualbert import VisualBertForTask
from visualbert_torch.ops import _build
from visualbert_torch.ops import mlm_xent as xe
from visualbert_torch.tools.weights import load_state

ROWS, TILE, COLS = 64, 64, 512  # the 1024 form's vb_xent_geometry 2, 4, 5: a cluster's rows, a tile, a block's columns
SMS = (132, 8)  # an H100's SMs, and a small card's: one block an SM, so SMS // 2 clusters at once


def covered_once(ranges, total):
    """The half-open ranges cover [0, total) with no gap and no overlap."""
    ranges = sorted(r for r in ranges if r[0] < r[1])
    return ranges[0][0] == 0 and ranges[-1][1] == total and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("V", [30522, 4099, 70])
@pytest.mark.parametrize("N", [3072, 37, 257, 1, 65])
def test_the_1024_plans_cover_every_row_block_tile_and_column_once(N, V, sms):
    """K5: cluster (x, z) keeps x rows [64 x, 64 x + 64) and the vocabulary
    tiles [z per, z per + per); its block of rank y writes the columns [512
    y, 512 y + 512) of part[z]. K6: cluster x keeps E rows [64 x, 64 x +
    64) over every x tile; block y its 512 columns. At N = 3072, V = 30522
    on 132 SMs (66 clusters at once) K5 takes 4 splits of 120 tiles."""
    plan = xe.wide_dx_plan(N, V, 1024, ROWS, TILE, COLS, sms // 2)
    row_blocks, R, S = plan["grid"]
    per, n_tiles = plan["per"], -(-V // TILE)
    assert R == 2 and plan["cluster"] == (1, 2, 1) and plan["panels"] == 8
    assert covered_once([(x * ROWS, min(N, x * ROWS + ROWS)) for x in range(row_blocks)], N)
    assert (row_blocks - 1) * ROWS < N  # no cluster without a row
    assert covered_once([(y * COLS, y * COLS + COLS) for y in range(R)], 1024)
    assert plan["tiles"] == n_tiles
    splits = [(z * per, min(n_tiles, z * per + per)) for z in range(S)]
    assert all(a < b for a, b in splits), "a split without a vocabulary tile"
    assert covered_once(splits, n_tiles)
    assert covered_once([(t * TILE, min(V, t * TILE + TILE)) for t in range(n_tiles)], V)
    assert plan["part_shape"] == (S, N, 1024)
    de = xe.wide_de_plan(V, 1024, ROWS, COLS)
    assert de["grid"][1] == 2 and covered_once([(x * ROWS, min(V, x * ROWS + ROWS)) for x in range(de["grid"][0])], V)
    if (N, V, sms) == (3072, 30522, 132):
        assert plan["grid"] == (48, 2, 4) and per == 120


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_k5_and_k6_form_each_tiles_logits_once_at_1024(dtype):
    """Two N x V x H products at 1024 and at every width padded onto it, in
    bf16 and fp16, on the form named "<dtype> H1024" (its launches keep
    their key)."""
    name = "bf16" if dtype == torch.bfloat16 else "fp16"
    for h in range(769, 1025):
        assert xe.kernel_width(h) == xe.H1024 and xe.bwd_products(dtype, h) == 2
        assert xe.xent_form(dtype, h) == f"{name} H1024"


def test_the_source_names_the_tiling_the_plans_assume():
    """The 1024 form's constants, its place in the form table and its
    cluster: what the plans here and ``launch_h1024_dx`` take."""
    src = (_build.CSRC / "mlm_xent.cu").read_text()
    for name, value in (("H_R", 2), ("H_CP", 8), ("H_ROWS", ROWS), ("H_TILE", TILE)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "{1024, Fwd<1024>::ROWS, H_ROWS, Fwd<1024>::T, H_TILE, H_CP * 64}" in src
    assert "launch_h1024_dx<ET>,\n              launch_h1024_de<ET>}" in src
    assert "attr->val.clusterDim.y = H_R;" in src
    assert "static_assert(H_SMEM <= 232448" in src
    # the old 1024 backward (a block of 512 columns, the logits formed twice) is gone
    assert "Bwd<1024>" not in src and "form_of<1024" not in src and "wgmma_n16" not in src


def inputs(seed, N, V, H=1024):
    """x, embedding, bias, labels (about 15 % -1, mapped to 0) and g (0 on
    those rows), fp32 numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(N, H).astype(np.float32)
    emb = (rng.randn(V, H) * 0.05).astype(np.float32)
    bias = (rng.randn(V) * 0.1).astype(np.float32)
    labels = rng.randint(0, V, N).astype(np.int32)
    labels[rng.rand(N) < 0.15] = -1
    g = np.where(labels >= 0, rng.uniform(0.5, 1.5, N), 0.0).astype(np.float32)
    return x, emb, bias, np.maximum(labels, 0), g


def emulate(x, emb, bias, labels, lse, g, sms=132):
    """The 1024 form's K5 and K6 in torch, in the kernel's order of sums:
    (dx, dE, db). Each streamed tile of 64 rows: each block's 8 panels of
    64 columns, each panel's products in fp32 (a fresh accumulator), added
    in panel order; the two blocks' sums, then the bias; dlog (K6: times g)
    rounded to the element type; the product added tile by tile in fp32. K5
    sums its vocabulary splits (wide_dx_plan's, at sms // 2 clusters) in
    order, then scales by g and rounds; K6's db sums the unrounded dlog."""
    et = x.dtype
    (N, H), V = x.shape, emb.shape[0]
    xf, ef = x.float(), emb.float()

    def logits(res, stream):  # [rows, cols] fp32 as the cluster forms them
        sums = []
        for rank in range(2):
            z = None
            for p in range(8 * rank, 8 * rank + 8):
                part = res[:, 64 * p:64 * p + 64] @ stream[:, 64 * p:64 * p + 64].t()
                z = part if z is None else z + part
            sums.append(z)
        return sums[0] + sums[1]

    plan = xe.wide_dx_plan(N, V, H, ROWS, TILE, COLS, sms // 2)
    part = torch.zeros(plan["part_shape"])
    for t in range(-(-V // TILE)):
        cols = slice(t * TILE, min(V, t * TILE + TILE))
        p = torch.exp(logits(xf, ef[cols]) + bias[cols] - lse[:, None])
        j = torch.arange(cols.start, cols.stop)
        dlog = (p - (labels[:, None].long() == j[None, :]).float()).to(et).float()
        part[t // plan["per"]] += dlog @ ef[cols]
    acc = part[0]
    for s in range(1, part.shape[0]):
        acc = acc + part[s]
    dx = (acc * g[:, None]).to(et)
    de, db = torch.zeros(V, H), torch.zeros(V)
    for t in range(-(-N // TILE)):
        rows = slice(t * TILE, min(N, t * TILE + TILE))
        p = torch.exp(logits(ef, xf[rows]) + bias[:, None] - lse[None, rows])
        i = torch.arange(rows.start, rows.stop)
        d = (p - (labels[None, rows].long() == torch.arange(V)[:, None]).float()) * g[None, rows]
        de += d.to(et).float() @ xf[rows]
        db += d.sum(1)
    return dx, de.to(et), db


def assert_half_close(got, want, what):
    """Two 16-bit results of the same products summed in other orders: one
    ulp of the element type apart at most (rtol 8e-3 of the value, atol 1e-2
    of the largest entry), as tests/test_torch_xent.py holds the plain
    versions to the JAX kernels."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=1e-2 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_the_kernels_order_of_sums_matches_jax_and_the_plain_versions(dtype):
    """At width 1024 (N = 64, V = 384: multiples of the JAX kernels'
    blocks), the emulated order of sums against the JAX backward kernels
    (``_bwd_impl``, interpret mode, on ``_fwd_impl``'s lse) and against the
    port's plain versions (mlm_xent_dx / _de on CPU tensors): dx and dE one
    ulp of the element type apart, db (fp32) to 1e-5."""
    N, V = 64, 384
    x, emb, bias, labels, g = inputs(11, N, V)
    jd = jnp.dtype(dtype)
    xj, ej, bj = jnp.asarray(x, jd), jnp.asarray(emb, jd), jnp.asarray(bias).reshape(1, V)
    lab = jnp.asarray(labels.reshape(N, 1))
    _, lse_j, _ = jax_xent._fwd_impl(xj, ej, bj, lab, nb=16, vbk=128)
    dx_j, de_j, db_j = jax_xent._bwd_impl(xj, ej, bj, lab, lse_j, jnp.asarray(g).reshape(N, 1), nb=16,
                                          vbk_dx=128, vbk_de=128)
    td = getattr(torch, dtype)
    xt, et, bt, lt, gt = (torch.tensor(x).to(td), torch.tensor(emb).to(td), torch.tensor(bias),
                          torch.tensor(labels), torch.tensor(g))
    lse = torch.tensor(np.asarray(lse_j)[:, 0])
    dx, de, db = emulate(xt, et, bt, lt, lse, gt)
    assert dx.dtype == td and de.dtype == td and db.dtype == torch.float32
    assert_half_close(dx.float(), dx_j, "dx against JAX")
    assert_half_close(de.float(), jnp.asarray(de_j, jd), "dE against JAX")
    np.testing.assert_allclose(db.numpy(), np.asarray(db_j)[0], atol=1e-5, rtol=1e-5)
    assert_half_close(dx.float(), xe.mlm_xent_dx(xt, et, bt, lt, lse, gt).float(), "dx against the plain version")
    de_p, db_p = xe.mlm_xent_de(xt, et, bt, lt, lse, gt)
    assert_half_close(de.float(), de_p.float(), "dE against the plain version")
    np.testing.assert_allclose(db.numpy(), db_p.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("N,V", [(37, 300), (65, 129), (1, 70)])
def test_the_emulated_kernel_masks_ragged_rows_and_tiles(N, V):
    """Ragged N and V (a partial row block, a partial last tile, a split
    count above one at (65, 129) on 8 SMs) give the plain versions' dx, dE
    and db in bf16."""
    x, emb, bias, labels, g = inputs(N + V, N, V)
    xt, et = torch.tensor(x).bfloat16(), torch.tensor(emb).bfloat16()
    bt, lt, gt = torch.tensor(bias), torch.tensor(labels), torch.tensor(g)
    _, lse, _ = xe.mlm_xent_fwd_reference(xt, et, bt, lt)
    dx, de, db = emulate(xt, et, bt, lt, lse, gt, sms=8)
    assert_half_close(dx.float(), xe.mlm_xent_dx(xt, et, bt, lt, lse, gt).float(), "dx")
    de_p, db_p = xe.mlm_xent_de(xt, et, bt, lt, lse, gt)
    assert_half_close(de.float(), de_p.float(), "dE")
    np.testing.assert_allclose(db.numpy(), db_p.numpy(), atol=1e-5, rtol=1e-5)


class Lib1024:
    """Records each entry point's call and answers 0; answers
    ``vb_xent_geometry`` with the 1024 form's tiling, and ``vb_xent_info`` /
    ``vb_xent_f16_info``'s `what` 4 with ``clusters``."""

    def __init__(self, clusters=66):
        self.calls, self.clusters = [], clusters

    def vb_xent_geometry(self, which, hid):
        return (1024, 64, ROWS, 32, TILE, COLS)[which] if hid == 1024 else -1

    def _info(self, kernel, what, hid):
        assert kernel in (0, 1) and what == 4 and hid == 1024
        return self.clusters

    vb_xent_info = vb_xent_f16_info = _info

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0

        return call


@pytest.mark.parametrize("dtype,prefix", [(torch.bfloat16, "vb_xent_"), (torch.float16, "vb_xent_f16_")], ids=str)
@pytest.mark.parametrize("role", ["dx", "de"])
def test_the_1024_launches_pass_their_signatures_arguments(monkeypatch, role, dtype, prefix):
    """The 1024 form's K5 and K6 launches hand their dtype's entry point one
    int per declared argument: the shape, and K5 the plan's splits and tiles
    a split (wide_dx_plan over the clusters at once) and a partials buffer of
    its shape."""
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    N, V = 100, 1000
    x, emb = torch.zeros((N, 1024), dtype=dtype), torch.zeros((V, 1024), dtype=dtype)
    rows = torch.zeros(N)
    args = (x, emb, torch.zeros(V), torch.zeros(N, dtype=torch.int32), rows, rows)
    lib = Lib1024()
    out = xe.launch_h1024_dx(lib, *args) if role == "dx" else xe.launch_h1024_de(lib, *args)
    ((called, values),) = lib.calls
    assert called == prefix + role and out[0] == 0
    assert len(values) == len(_build._SIGNATURES[called]) and all(type(v) is int for v in values)
    assert values[6:9] == (N, V, 1024)
    if role == "dx":
        plan = xe.wide_dx_plan(N, V, 1024, ROWS, TILE, COLS, lib.clusters)
        assert values[9:11] == (plan["grid"][2], plan["per"]) and out[1].shape == (N, 1024)
    else:
        assert out[1].shape == (V, 1024) and out[2].shape == (V,)


@pytest.mark.parametrize("role", ["dx", "de"])
def test_the_1024_launch_raises_where_no_cluster_fits(monkeypatch, role):
    """No cluster on the card: the launch raises before it calls an entry
    point; nothing falls back to the plain version or another form."""
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    xe.h1024_clusters.cache_clear()
    N, V = 10, 70
    args = (torch.zeros((N, 1024), dtype=torch.bfloat16), torch.zeros((V, 1024), dtype=torch.bfloat16),
            torch.zeros(V), torch.zeros(N, dtype=torch.int32), torch.zeros(N), torch.zeros(N))
    lib = Lib1024(clusters=0)
    with pytest.raises(RuntimeError, match="no cluster of K[56] at width 1024 fits"):
        (xe.launch_h1024_dx if role == "dx" else xe.launch_h1024_de)(lib, *args)
    assert lib.calls == []


def test_large_pretraining_with_the_fused_cross_entropy_matches_jax():
    """VisualBertForTask("pretraining") at large()'s widths (H = 1024, 16
    heads, I = 4096; one layer, a vocabulary of 512, fp32, dropout off) with
    fused_mlm_xent, on the JAX model's exported weights: loss,
    masked_lm_loss, next_sentence_loss and every parameter gradient against
    the JAX model without fused_mlm_xent (the fused JAX op cannot be
    differentiated, ROADMAP C1), at the fp32 bar (atol 2e-5, rtol 1e-4)."""
    atol, rtol = 2e-5, 1e-4
    small = dict(num_hidden_layers=1, vocab_size=512, max_position_embeddings=64, visual_embedding_dim=16,
                 hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    jcfg = JaxConfig.large(**small, dtype=jnp.float32, fused_mlm_xent=False)
    tcfg = VisualBertConfig.large(**small, dtype=torch.float32, fused_mlm_xent=True)
    assert (tcfg.hidden_size, tcfg.num_attention_heads, tcfg.intermediate_size) == (1024, 16, 4096)
    rng = np.random.RandomState(5)
    B, TT, TV, P = 2, 10, 4, 3
    lm = np.full((B, TT), -1, np.int32)
    pos = np.zeros((B, P), np.int32)
    for i in range(B):
        p = np.sort(rng.choice(np.arange(1, TT), size=P, replace=False))
        pos[i] = p
        lm[i, p[:2]] = rng.randint(0, jcfg.vocab_size, size=2)
    batch = {
        "input_ids": rng.randint(0, jcfg.vocab_size, (B, TT)).astype(np.int32),
        "token_type_ids": rng.randint(0, 2, (B, TT)).astype(np.int32),
        "input_mask": np.ones((B, TT), np.int32),
        "visual_embeddings": rng.randn(B, TV, 16).astype(np.float32),
        "image_mask": np.ones((B, TV), np.int32),
        "visual_embeddings_type": np.ones((B, TV), np.int32),
        "masked_lm_labels": lm,
        "mlm_positions": pos,
        "is_random_next": rng.randint(0, 2, (B,)).astype(np.int32),
    }
    jbatch = jax.tree.map(jnp.asarray, batch)
    jm = JaxTask(jcfg, head_type="pretraining")
    params = unbox(jax.jit(jm.init)(jax.random.PRNGKey(3), jbatch)["params"])
    out_j = jax.jit(lambda p: jm.apply({"params": p}, jbatch, deterministic=True))(params)
    grads_j = jax.jit(jax.grad(lambda p: jm.apply({"params": p}, jbatch, deterministic=True)["loss"]))(params)

    model = load_state(VisualBertForTask(tcfg, "pretraining"), export_state_dict(params, jcfg)).eval()
    out_t = model({k: torch.tensor(v).long() if v.dtype.kind == "i" else torch.tensor(v) for k, v in batch.items()})
    out_t["loss"].backward()
    for k in ("loss", "masked_lm_loss", "next_sentence_loss"):
        np.testing.assert_allclose(float(out_t[k].detach()), float(out_j[k]), atol=atol, rtol=rtol, err_msg=k)
    want = export_state_dict(grads_j, jcfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=atol, rtol=rtol, err_msg=name)
