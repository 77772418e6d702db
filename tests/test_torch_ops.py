"""visualbert_torch ops on the CPU against the JAX package.

The attention op's plain path (what the port runs on CPU tensors) is held
against ``visualbert_tpu.ops.flash_attention.flash_attention_packed``, whose
Pallas kernel runs in interpret mode here, on the same numpy inputs: fp32,
dropout off, atol 2e-5 / rtol 1e-4 (the bar the JAX encoder meets against
HF). With dropout on the two draw different bits, so the port is checked by
distribution and by forward/backward mask agreement instead. The CUDA
kernels themselves are tested on the card (tests/test_torch_kernels_cuda.py).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualbert_tpu.ops.flash_attention import flash_attention_packed as jax_flash_packed
from visualbert_torch.ops import flash_attention as fa
from visualbert_torch.ops.dropout import dropout_mask, fast_dropout
from visualbert_torch.ops.philox import philox4x32_10

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 2e-5, 1e-4


def attention_inputs(rng, B=2, T=21, H=4, D=16):
    F = 3 * H * D
    qkv = rng.randn(B, T, F).astype(np.float32)
    qb = (rng.randn(F) * 0.1).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, -6:] = 0
    mask[1, -1:] = 0
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    dout = rng.randn(B, T, H * D).astype(np.float32)
    return qkv, qb, bias, dout


@pytest.mark.parametrize("T", [21, 16])
def test_packed_attention_matches_jax(rng, T):
    H = 4
    qkv, qb, bias, dout = attention_inputs(rng, T=T, H=H)

    def jax_loss(x, b):
        out = jax_flash_packed(x, H, jnp.asarray(bias), qkv_bias=b)
        return jnp.sum(out * jnp.asarray(dout)), out

    (_, out_j), (dx_j, db_j) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(qb)
    )
    x = torch.tensor(qkv, requires_grad=True)
    b = torch.tensor(qb, requires_grad=True)
    out_t = fa.flash_attention_packed(x, H, torch.tensor(bias), qkv_bias=b)
    out_t.backward(torch.tensor(dout))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dx_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(b.grad.numpy(), np.asarray(db_j), atol=ATOL, rtol=RTOL)


def test_packed_attention_stats_are_base2_logsumexp(rng):
    H = 4
    qkv, qb, bias, _ = attention_inputs(rng, H=H)
    x, b, kb = torch.tensor(qkv), torch.tensor(qb), torch.tensor(bias[:, 0, 0, :])
    _, stats = fa.packed_attention_fwd(x, b, kb, H, 0.0, 0)
    q, k, _ = fa._split_heads(x + b, H)
    s = torch.matmul(q, k.transpose(-1, -2)) / 4.0 + kb[:, None, None, :]
    want = torch.logsumexp(s, dim=-1) / np.log(2.0)
    np.testing.assert_allclose(stats.numpy(), want.numpy(), atol=1e-5, rtol=1e-6)


def test_philox_known_answers():
    # Random123 known-answer vectors for philox4x32-10
    cases = [
        ((0, 0, 0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 6, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for args, want in cases:
        assert tuple(int(w) for w in philox4x32_10(*args)) == want


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_dropout_mask_distribution_and_determinism(dtype):
    shape, rate = (6, 33, 64), 0.1
    a = dropout_mask(shape, rate, 11, dtype)
    assert a.shape == shape and a.dtype == dtype
    assert torch.equal(a, dropout_mask(shape, rate, 11, dtype))
    assert not torch.equal(a, dropout_mask(shape, rate, 12, dtype))
    keep = (a != 0).float().mean().item()
    n = a.numel()
    assert abs(keep - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / n)
    vals = set(torch.unique(a.float()).tolist())
    want_one = 1.0 if dtype == torch.int8 else float(torch.tensor(1 / (1 - rate), dtype=torch.float32).to(dtype))
    assert vals == {0.0, want_one}


def test_fast_dropout_gradient_is_the_mask():
    x = torch.randn(4, 9, 32, requires_grad=True)
    y = fast_dropout(x, 0.25, 3)
    y.backward(torch.ones_like(y))
    m = dropout_mask(x.shape, 0.25, 3).float() / 0.75
    torch.testing.assert_close(y, x.detach() * m)
    torch.testing.assert_close(x.grad, m)
    assert fast_dropout(x, 0.0, 3) is x


def test_attention_dropout_forward_backward_share_the_mask(rng):
    """Backward at rate > 0 is the gradient of the forward with the same
    mask: compare with autograd through an explicit softmax that applies
    the twin's mask."""
    H, D, B, T, rate, seed = 4, 16, 2, 21, 0.2, 77
    qkv, qb, bias, dout = attention_inputs(rng, B=B, T=T, H=H, D=D)
    keep = fa.attention_keep_reference(seed, B, H, T, rate)
    assert abs(keep.float().mean().item() - (1 - rate)) < 4 * np.sqrt(rate * (1 - rate) / keep.numel())

    def explicit(x, b):
        q, k, v = fa._split_heads(x + b, H)
        s = torch.matmul(q, k.transpose(-1, -2)) / np.sqrt(D) + torch.tensor(bias)
        p = torch.softmax(s, dim=-1) * keep / (1 - rate)
        return torch.matmul(p, v).permute(0, 2, 1, 3).reshape(B, T, H * D)

    grads = []
    for fn in (explicit, lambda x, b: fa.flash_attention_packed(x, H, torch.tensor(bias), rate, seed, qkv_bias=b)):
        x = torch.tensor(qkv, requires_grad=True)
        b = torch.tensor(qb, requires_grad=True)
        out = fn(x, b)
        out.backward(torch.tensor(dout))
        grads.append((out.detach(), x.grad, b.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=RTOL)


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil, visualbert_torch\n"
        "for m in pkgutil.walk_packages(visualbert_torch.__path__, 'visualbert_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'visualbert_tpu'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_main_path_model_block():
    """configs/coco_pretrain.json's model block, comments stripped, with the
    fused MLM cross-entropy off; TPU-only fields are skipped by from_dict."""
    from visualbert_torch.config import VisualBertConfig
    from visualbert_torch.tools import main_path

    block = main_path.model_block()
    assert block["fused_mlm_xent"] is False
    cfg = VisualBertConfig.from_dict(dict(block, scan_layers=False, remat=True, mesh=None))
    cfg.check_ported()
    assert cfg.use_flash_attention and cfg.fast_dropout and cfg.packed_qkv
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads, cfg.visual_embedding_dim) == (
        768, 12, 12, 2048)
    assert not hasattr(cfg, "scan_layers")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device here: chip_smoke.py must exit non-zero and print no
    result, both from the repo and from a directory that holds only it."""
    src = os.path.join(REPO, "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(src).read())
    for path, cwd in ((src, REPO), (str(alone), str(tmp_path))):
        proc = subprocess.run([sys.executable, path], cwd=cwd, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
