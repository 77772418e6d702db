"""CUDA kernels of visualbert_torch against their plain versions, on the card.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest sets up JAX). Every test skips where
``torch.cuda.is_available()`` is false. Tolerances are for bf16 operands:
the kernels round unnormalised probabilities to bf16 before PV where the
plain version rounds normalised ones, and sum in another order, so outputs
agree to a few bf16 ulps (relative error of the max below 2e-2); the fp32
softmax statistics agree to 1e-4; the dropout masks agree exactly, and
the dropout site's forward and backward (K3's body) give y, the packed
keep bits and dx bit for bit at the main path's, NLVR2's and small shapes,
every tail length up to 17, bf16, fp16 and fp32, keep NaN at a dropped
position NaN, do not spill, and so do ``tools/dropout_steps.py``'s builds
with a design step left out. The MLM
cross-entropy kernels (K4-K6) sum the same fp32 products in another order:
nll and lse within 1e-3 absolute, the argmax equal wherever the plain top-2
gap exceeds 1e-3 (first max on an exact tie), dx and dE (bf16) within 2e-2
and db (fp32) within 1e-3 of the largest plain value. The LayerNorm kernels
(K7-K10) compute the plain version's fp32 values in another order and round
once: y, dx and dres within 2e-2 of the largest plain value, mu and rstd
within 1e-4, dscale and dbias within 1e-3; their dropout masks agree
exactly: K9's saved keep bits equal the plain bits, and K10 on them drops
exactly the plain positions, at every dtype, rates 0.1 and 0.5, widths
whose bits rows are no multiple of 16 or 4 bytes and row counts that leave
the backward's ring partly filled. K7-K10 repeat bit for bit and do not
spill (``vb_ln_info``); ``tools/ln_steps.py``'s builds of K8/K10 that draw
the mask again or copy rows synchronously give their outputs bit for bit.
The heads-major (K11/K12) and save-probs (K13/K14) attention
kernels are held as K1/K2 are, at small shapes and at the main path's T =
228, NLVR2's T = 272 and their largest, 704; each of K13's bf16
probabilities within one bf16 ulp of its plain value, and K14 fed K13's
own output as K2 is. Both pairs (``csrc/flash_attention.cu`` and
``csrc/flash_attention_sp.cu``, on K1/K2's design) also repeat bit for bit,
drop exactly the plain mask's positions and refuse T = 1024; K11/K12 give
K1/K2's outputs bit for bit on the same numbers with a zero QKV bias, and
K14 gives the same dqkv from K13's padded-stride probabilities and from a
contiguous copy. The
attention experiment kernels (``csrc/flash_attention_exp.cu``, K1/K2's
design in bodies of their own: K15 with every variant of ``VARIANTS`` and
two more knob settings, so every compiled flag combination runs; K16 at
every hg that divides H) are held as K1/K2 are, at dropout 0 and 0.1; each
numerics flag also at T in {1, 37, 228, 272} and its largest T (704, 448
for prescale's backward, refused one past it); with the flags off every
schedule gives K1/K2's out, stats and dqkv bit for bit; they repeat bit for
bit and none of their 12 kernels spills (``vb_attn_exp_info``).
K1/K2 (``csrc/flash_attention_packed.cu``) also run at T = 1, 272 and 512,
repeat bit for bit, drop exactly the plain mask's positions, and refuse T =
1024; ``tools/attn_steps.py``'s builds of their source with a design step
left out, and of K13/K14's with synchronous copies, give the kernels'
outputs bit for bit. K4-K6 also run at bert-large's
hidden width of 1024. K4 (``xent_fwd_kernel``: x in wgmma A fragments,
cp.async ring) and K5/K6 (``xent_bwd_kernel``: wgmma, cp.async; at 1024
``xent_h1024_bwd_kernel``, a cluster of two blocks, TMA) run at
every ragged, single and whole row block, vocabulary tile and split of N in
{3072, 37, 257, 1, 65} and V in {30522, 4099, 70} (width 1024 at N in
{3072, 37} for K5/K6, at every N for K4), repeat bit for bit, do not spill,
and have the tiling that ``tests/test_torch_xent_geometry.py`` plans their
grids with; K4's argmax takes the first of equal maxima.

The other forms of K1/K2 and K4-K6 (``tests/test_torch_kernel_dtypes.py``
holds their plain versions against JAX on the CPU): K1/K2 in bf16, fp16
and fp32 at head dims 8, 16, 32, 64, 96 and 128 (bf16 and fp16 zero-padded
to the kernels' 64 or 128; K2's to 16 or 32 below 33, where its small-row
forms run: also at 26, at T = 1, 65, 228 and their largest, above 704,
each refusing one more; their two products checked alone against fp32
matmul; no spill), dropout 0 and 0.1, against the plain versions
as above (fp32 within 1e-4 relative, its stats within 1e-4), repeating bit
for bit, dropping exactly the plain mask's positions, and at D = 128
taking T up to 256 and refusing 257 (fp32 has no such limit: T = 1024
runs); K4-K6 in bf16 and fp16 at widths 32 to 1024 (every instantiated
width and padded ones between), both on the wide form at 1088, 2048 and
2560, and fp32 at any width (the tiled kernels, at 32 to 2048), as
above (fp32's dx, dE and db within 1e-4 of the largest plain value, nll
and lse within 1e-4), repeating bit for bit, none spilling, and the first
of equal maxima taken by the fp32 and the wide forms. The wide K5/K6 (a
thread-block cluster a row block) also at H in {1088, 1536, 2048, 2560,
4160, 6144, 8192} (4160: a cluster of 9 blocks) x N in {1, 65, 3071} x V
in {70, 4099, 30522}, in both dtypes (fp16 also at a padded 1100),
repeating bit for bit, none spilling, their clusters fitting the card;
the wide K4 at 1088 to 8192 x N in {1, 200, 3071} x V in {1000, 30522}
in both dtypes; the wide forms' nll, lse and db held to the exact
products' where the plain version's fp32 sums drift.

The register-tiled fp32 kernels (K1/K11's and K13's forwards and the
backward of K2, K12 and K14, ``csrc/flash_attention_f32.cu``; K1/K11's
forward also at D in {1, 26}) at T in {1, 63, 64, 65, 228,
1000} (both sides of a 64-row tile, and above the bf16 kernels' 704) and D
in {16, 30, 64, 99, 100, 128} (30 and 99 copied 4 bytes a piece), dropout 0 and 0.1, with a key tile wholly masked:
within 1e-4 of the plain versions (stats 1e-4 absolute), K13's
probabilities within one bf16 ulp; they repeat bit for bit, do not spill
(two blocks an SM at D <= 64) and tile the backward by 64 rows; their
masks are held, with the other forms', by the forms' mask tests above.

K12 and K14 at head dims up to 32 in bf16 and fp16 (their small-row forms,
as K2's: 16 and 32 in place, 8 and 26 padded) at T in {1, 65, 228} and
each form's largest (above 704, on the plain forward's outputs), dropout 0
and 0.1, within bf16's limit of their plain versions, K14 also on K13's
own probabilities; each launch counted in its form; they repeat bit for
bit, drop the plain mask's positions, refuse one T past their limit, do
not spill, and build no forward at those head dims.
"""

import numpy as np
import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import attention_exp as ae
from visualbert_torch.ops import dropout as dropout_ops
from visualbert_torch.ops import flash_attention as fa
from visualbert_torch.ops import layer_norm as ln
from visualbert_torch.ops import mlm_xent as xe
from visualbert_torch.ops.dropout import dropout_mask, dropout_mask_reference

pytestmark = pytest.mark.gpu

REL_TOL = 2e-2
STATS_ATOL = 1e-4
XENT_ATOL = 1e-3   # nll, lse (fp32, absolute)
ARGMAX_GAP = 1e-3  # rows whose plain top-2 logit gap exceeds this must agree
DB_REL_TOL = 1e-3  # db (fp32), share of the largest plain value


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel_err(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


def attention_inputs(B, T, H, device, seed=0):
    rng = np.random.RandomState(seed)
    F = 3 * H * 64
    qkv = torch.tensor(rng.randn(B, T, F), dtype=torch.bfloat16, device=device)
    qb = torch.tensor(rng.randn(F) * 0.1, dtype=torch.bfloat16, device=device)
    mask = np.ones((B, T), np.float32)
    mask[0, T - T // 3:] = 0
    if B > 1:
        mask[1, -1:] = 0
    key_bias = torch.tensor((1.0 - mask) * -10000.0, device=device)
    dout = torch.tensor(rng.randn(B, T, H * 64), dtype=torch.bfloat16, device=device)
    return qkv, qb, key_bias, dout


@pytest.mark.parametrize("shape", [(96, 228, 768), (1001,), (3, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32, torch.float16])
def test_dropout_mask_matches_twin(cuda, shape, dtype):
    got = dropout_mask(shape, 0.1, 1234, dtype, cuda)
    want = dropout_mask_reference(shape, 0.1, 1234, dtype, cuda)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    keep = (got != 0).float().mean().item()
    n = got.numel()
    assert abs(keep - 0.9) <= 4 * np.sqrt(0.09 / n) + 1e-9


def test_dropout_mask_seeds(cuda):
    a = dropout_mask((96, 228, 768), 0.1, 7, torch.int8, cuda)
    b = dropout_mask((96, 228, 768), 0.1, 7, torch.int8, cuda)
    c = dropout_mask((96, 228, 768), 0.1, 8, torch.int8, cuda)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


SITE_SHAPES = [(128, 228, 768), (64, 272, 768), (6, 33, 64), (1001,), (3, 5, 7)]
SITE_DTYPES = [torch.bfloat16, torch.float16, torch.float32]
INT_VIEW = {torch.bfloat16: torch.int16, torch.float16: torch.int16, torch.float32: torch.int32}


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(INT_VIEW[a.dtype]), b.view(INT_VIEW[b.dtype]))


def site_inputs(shape, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.tensor(rng.randn(*shape), dtype=torch.float32).to(dtype).to(device) for _ in range(2))


@pytest.mark.parametrize("rate", [0.1, 0.25])
@pytest.mark.parametrize("dtype", SITE_DTYPES, ids=str)
@pytest.mark.parametrize("shape", SITE_SHAPES, ids=str)
def test_dropout_site_kernels_match_plain(cuda, shape, dtype, rate):
    """The site forward's y and bits and the backward's dx equal the plain
    versions in every bit, and repeat bit for bit."""
    x, dy = site_inputs(shape, dtype, cuda)
    y, bits = dropout_ops.dropout_fwd(x, rate, 99)
    dx = dropout_ops.dropout_bwd(dy, bits, rate)
    y_r, bits_r = dropout_ops.dropout_fwd_reference(x, rate, 99)
    dx_r = dropout_ops.dropout_bwd_reference(dy, bits_r, rate)
    y2, bits2 = dropout_ops.dropout_fwd(x, rate, 99)
    torch.cuda.synchronize()
    assert bits.dtype == torch.uint8 and bits.shape == (-(-x.numel() // 8),)
    assert same_bits(y, y_r) and torch.equal(bits, bits_r) and same_bits(dx, dx_r)
    assert same_bits(y2, y) and torch.equal(bits2, bits)
    keep = float(dropout_ops.unpack_keep(bits, x.numel()).float().mean())
    assert abs(keep - (1 - rate)) <= 4 * np.sqrt(rate * (1 - rate) / x.numel()) + 1e-9


@pytest.mark.parametrize("n", list(range(1, 18)))
@pytest.mark.parametrize("dtype", SITE_DTYPES, ids=str)
def test_dropout_kernels_at_tail_lengths(cuda, dtype, n):
    """n elements, n not a multiple of 16 (the tail path) or 16: the site
    kernels and K3 (int8 and in the dtype) as the plain versions, the bits'
    tail byte padded with zeros."""
    x, dy = site_inputs((n,), dtype, cuda, seed=n)
    y, bits = dropout_ops.dropout_fwd(x, 0.5, 3)
    dx = dropout_ops.dropout_bwd(dy, bits, 0.5)
    y_r, bits_r = dropout_ops.dropout_fwd_reference(x, 0.5, 3)
    torch.cuda.synchronize()
    assert same_bits(y, y_r) and torch.equal(bits, bits_r)
    assert same_bits(dx, dropout_ops.dropout_bwd_reference(dy, bits_r, 0.5))
    assert int(bits[-1]) >> (n % 8 or 8) == 0
    for mdt in (torch.int8, dtype):
        assert torch.equal(dropout_mask((n,), 0.5, 3, mdt, cuda), dropout_mask_reference((n,), 0.5, 3, mdt, cuda))


@pytest.mark.parametrize("dtype", SITE_DTYPES, ids=str)
def test_dropout_site_keeps_a_nan_at_a_dropped_position(cuda, dtype):
    """The forward multiplies: NaN and inf at dropped positions give NaN in
    y (as the eager composition and the JAX package do); so does a NaN of dy
    in dx."""
    shape, rate, seed = (6, 33, 64), 0.25, 9
    keep = dropout_mask_reference(shape, rate, seed, torch.int8, cuda).reshape(-1)
    dropped = torch.nonzero(keep == 0)[:2, 0]
    x, dy = site_inputs(shape, dtype, cuda)
    x.view(-1)[dropped[0]] = float("nan")
    x.view(-1)[dropped[1]] = float("inf")
    dy.view(-1)[dropped[0]] = float("nan")
    y, bits = dropout_ops.dropout_fwd(x, rate, seed)
    dx = dropout_ops.dropout_bwd(dy, bits, rate)
    torch.cuda.synchronize()
    assert torch.isnan(y.view(-1)[dropped]).all() and int(torch.isnan(y).sum()) == 2
    assert torch.isnan(dx.view(-1)[dropped[0]]) and int(torch.isnan(dx).sum()) == 1


def test_dropout_kernels_fill_the_card_and_do_not_spill(cuda):
    """K3 (every dtype) and the site kernels (bf16, fp16, fp32): registers,
    no local memory, at least one block an SM (their launches run one group
    of 16 a thread, 5,472 blocks at the main path's shape)."""
    lib = _build.library()
    for kernel, codes in ((dropout_ops.MASK, (0, 1, 2, 3)), (dropout_ops.SITE_FWD, (1, 2, 3)),
                          (dropout_ops.SITE_BWD, (1, 2, 3))):
        for code in codes:
            regs, local, _, per_sm = (lib.vb_dropout_info(kernel, w, code) for w in range(4))
            assert regs > 0 and local == 0 and per_sm >= 1, (kernel, code, regs, local, per_sm)
    assert lib.vb_dropout_info(dropout_ops.SITE_FWD, 0, 0) == -1  # the site takes no int8


def test_dropout_refuses_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(64, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="bf16, fp16 or fp32"):
        dropout_ops.dropout_fwd(x, 0.1, 1)
    y = torch.zeros(65, dtype=torch.bfloat16, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        dropout_ops.dropout_fwd(y, 0.1, 1)
    with pytest.raises(ValueError, match="keep bits"):
        dropout_ops.dropout_bwd(y.clone(), torch.zeros(4, dtype=torch.uint8, device=cuda), 0.1)
    with pytest.raises(ValueError, match="outside"):
        dropout_ops.dropout_fwd(y.clone(), 1.0, 1)


def test_dropout_steps_builds_give_the_kernels_bits(cuda):
    """tools/dropout_steps.py's builds with a design step left out (one
    Philox call a thread, a resident grid, the mask drawn again in the
    backward) give K3's and the site kernels' outputs bit for bit."""
    from visualbert_torch.tools import dropout_steps

    builds, _ = dropout_steps.build_all()
    d = dropout_steps.data(cuda)
    dropout_steps.check(builds, d, "card test")


@pytest.mark.parametrize("B,T,H", [(4, 228, 12), (2, 37, 3), (1, 64, 2), (2, 130, 4), (3, 1, 12), (1, 512, 16),
                                   (5, 272, 12)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_kernels_match_plain(cuda, B, T, H, rate):
    qkv, qb, key_bias, dout = attention_inputs(B, T, H, cuda)
    out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 99)
    out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 99)
    torch.cuda.synchronize()
    assert rel_err(out, out_r) < REL_TOL
    assert float((stats - stats_r).abs().max()) < STATS_ATOL
    # the backward gets the same forward output and stats on both sides
    dqkv, dqb = fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
    dqkv_r, dqb_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
    torch.cuda.synchronize()
    assert rel_err(dqkv, dqkv_r) < REL_TOL
    assert rel_err(dqb, dqb_r) < REL_TOL


def test_attention_kernels_repeat_bit_for_bit(cuda):
    qkv, qb, key_bias, dout = attention_inputs(4, 228, 12, cuda)
    runs = []
    for _ in range(2):
        out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, 12, 0.1, 7)
        runs.append((out, stats) + fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, 12, 0.1, 7))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_attention_kernels_drop_the_plain_mask(cuda):
    """With v[j] the j-th unit vector (T = 64 = D keys, no key padding, no
    bias) out[i, j] is the dropped, rescaled p[i, j], zero exactly where the
    plain mask drops (every p > 0); with dout[i] the i-th unit vector the dK/dV
    pass's dv[j, i] is the same p_d[i, j]."""
    B, T, H, rate, seed = 3, 64, 2, 0.1, 11
    rng = np.random.RandomState(5)
    qkv = torch.tensor(rng.randn(B, T, H, 3, 64), dtype=torch.bfloat16, device=cuda)
    qkv[:, :, :, 2] = torch.eye(T, dtype=torch.bfloat16, device=cuda)[None, :, None]
    qkv = qkv.reshape(B, T, 3 * H * 64).contiguous()
    qb = torch.zeros(3 * H * 64, dtype=torch.bfloat16, device=cuda)
    key_bias = torch.zeros((B, T), device=cuda)
    dout = torch.eye(T, dtype=torch.bfloat16, device=cuda)[None, :, None].expand(B, T, H, 64).reshape(B, T, H * 64)
    out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, seed)
    dqkv, _ = fa.packed_attention_bwd(qkv, qb, key_bias, dout.contiguous(), out, stats, H, rate, seed)
    torch.cuda.synchronize()
    keep = fa.attention_keep_reference(seed, B, H, T, rate, cuda)  # [B, H, i, j]
    p_d = out.view(B, T, H, 64).permute(0, 2, 1, 3)  # [B, H, i, j]
    dv = dqkv.view(B, T, H, 3, 64)[:, :, :, 2].permute(0, 2, 3, 1)  # [B, H, i, j] = dv[j, i]
    assert 0.05 < 1 - float(keep.float().mean()) < 0.15
    assert torch.equal(p_d != 0, keep)
    assert torch.equal(dv != 0, keep)


def test_attention_kernels_refuse_t_1024(cuda):
    """T = 512 runs in test_attention_kernels_match_plain; 1024 needs more
    shared memory than a block has."""
    qkv, qb, key_bias, dout = attention_inputs(1, 1024, 1, cuda)
    for what in (lambda: fa.packed_attention_fwd(qkv, qb, key_bias, 1, 0.0, 0),
                 lambda: fa.packed_attention_bwd(qkv, qb, key_bias, dout, dout, key_bias.view(1, 1, -1), 1, 0.0, 0)):
        with pytest.raises(ValueError, match="shared memory"):
            what()


@pytest.fixture(scope="module")
def step_builds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from visualbert_torch.tools import attn_steps

    return attn_steps.build_all()[0]


@pytest.mark.parametrize("B,T", [(3, 130), (2, 37), (1, 228)])
@pytest.mark.parametrize("name", ["philox per row", "sync loads"])
def test_design_step_builds_equal_the_kernels(cuda, step_builds, name, B, T):
    """tools/attn_steps.py's builds of csrc/flash_attention_packed.cu with
    step 2 (shared Philox) or step 3 (cp.async) left out draw the same mask
    and do the same arithmetic: K1/K2's outputs bit for bit at dropout 0.1."""
    from visualbert_torch.ops import _build
    from visualbert_torch.tools import attn_steps

    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    qkv, qb, key_bias, dout = attention_inputs(B, T, attn_steps.H, cuda)
    runs = []
    for b in (attn_steps.PackedBuild("as built", _build.library(), B, T, n_sm),
              attn_steps.PackedBuild(name, step_builds[name], B, T, n_sm)):
        out, stats = b.fwd(qkv, qb, key_bias, 0.1, 3)
        runs.append((out, stats) + b.bwd(qkv, qb, key_bias, dout, out, stats, 0.1, 3))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    out_r, _ = fa.packed_attention_fwd_reference(qkv, qb, key_bias, attn_steps.H, 0.1, 3)
    assert rel_err(runs[1][0], out_r) < REL_TOL


@pytest.mark.parametrize("B,T", [(3, 130), (2, 37), (1, 228)])
def test_sp_sync_loads_build_equals_the_kernels(cuda, step_builds, B, T):
    """tools/attn_steps.py's build of csrc/flash_attention_sp.cu with
    synchronous copies in place of cp.async: K13/K14's outputs bit for bit
    at dropout 0.1."""
    from visualbert_torch.ops import _build
    from visualbert_torch.tools import attn_steps

    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    qkv, qb, key_bias, dout = attention_inputs(B, T, attn_steps.H, cuda)
    qkv = qkv + qb
    runs = []
    for b in (attn_steps.SpBuild("as built", _build.library(), B, T, n_sm),
              attn_steps.SpBuild("sp sync loads", step_builds["sp sync loads"], B, T, n_sm)):
        out, probs = b.fwd(qkv, key_bias, 0.1, 3)
        runs.append((out, probs, b.bwd(qkv, probs, dout, out, 0.1, 3)))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def heads_major_inputs(B, T, H, device, seed=0):
    rng = np.random.RandomState(seed)
    qkv = torch.tensor(rng.randn(B, 3, H, T, 64), dtype=torch.bfloat16, device=device)
    _, _, key_bias, _ = attention_inputs(B, T, H, device, seed)
    dout = torch.tensor(rng.randn(B, H, T, 64), dtype=torch.bfloat16, device=device)
    return qkv, key_bias, dout


def bf16_ulps(x):
    """One bf16 ulp at each entry of x, and at least 2^-126 (fp32's least
    normal value: below it a kernel may flush to zero)."""
    tiny = 2.0 ** -126
    _, e = torch.frexp(x.float().abs().clamp_min(tiny))  # |x| in [2^(e-1), 2^e)
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8).clamp_min(tiny)


VARIANT_SHAPES = [(4, 228, 12), (2, 272, 12), (2, 37, 3), (1, 64, 2), (2, 130, 4)]


@pytest.mark.parametrize("B,T,H", VARIANT_SHAPES + [(1, 704, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_heads_major_kernels_match_plain(cuda, B, T, H, rate):
    qkv, key_bias, dout = heads_major_inputs(B, T, H, cuda)
    out, stats = fa.heads_major_attention_fwd(qkv, key_bias, rate, 99)
    out_r, stats_r = fa.heads_major_attention_fwd_reference(qkv, key_bias, rate, 99)
    dqkv = fa.heads_major_attention_bwd(qkv, key_bias, dout, out_r, stats_r, rate, 99)
    dqkv_r = fa.heads_major_attention_bwd_reference(qkv, key_bias, dout, out_r, stats_r, rate, 99)
    torch.cuda.synchronize()
    assert out.shape == (B, H, T, 64) and dqkv.shape == qkv.shape
    assert rel_err(out, out_r) < REL_TOL
    assert float((stats - stats_r).abs().max()) < STATS_ATOL
    assert rel_err(dqkv, dqkv_r) < REL_TOL


@pytest.mark.parametrize("B,T,H", VARIANT_SHAPES + [(1, 704, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_save_probs_kernels_match_plain(cuda, B, T, H, rate):
    qkv, qb, key_bias, dout = attention_inputs(B, T, H, cuda)
    qkv = qkv + qb  # K13 takes the biased projection
    out, probs = fa.packed_attention_sp_fwd(qkv, key_bias, H, rate, 99)
    out_r, probs_r = fa.packed_attention_sp_fwd_reference(qkv, key_bias, H, rate, 99)
    dqkv = fa.packed_attention_sp_bwd(qkv, probs_r, dout, out_r, H, rate, 99)
    dqkv_r = fa.packed_attention_sp_bwd_reference(qkv, probs_r, dout, out_r, H, rate, 99)
    dqkv_own = fa.packed_attention_sp_bwd(qkv, probs, dout, out, H, rate, 99)  # the kernels' own chain
    torch.cuda.synchronize()
    assert probs.dtype == torch.bfloat16 and probs.shape == (B, H, T, T)
    assert fa.probs_layout(probs, B, H, T) == fa.probs_row_stride(T)  # K14 reads K13's p without a copy
    assert rel_err(out, out_r) < REL_TOL
    # each probability within one bf16 ulp of its own plain value
    assert bool(((probs.float() - probs_r.float()).abs() <= bf16_ulps(probs_r)).all())
    assert rel_err(dqkv, dqkv_r) < REL_TOL
    assert rel_err(dqkv_own, dqkv_r) < REL_TOL


def test_variants_equal_the_packed_kernel_without_dropout(cuda):
    """At dropout 0 the three forward kernels compute one function of the
    same numbers in three layouts."""
    B, T, H = 2, 228, 12
    qkv5, key_bias, _ = heads_major_inputs(B, T, H, cuda, seed=4)
    packed = qkv5.permute(0, 3, 2, 1, 4).reshape(B, T, 3 * H * 64).contiguous()
    o1, _ = fa.packed_attention_fwd(packed, torch.zeros(3 * H * 64, dtype=torch.bfloat16, device=cuda), key_bias,
                                    H, 0.0, 0)
    o11, _ = fa.heads_major_attention_fwd(qkv5, key_bias, 0.0, 0)
    o13, _ = fa.packed_attention_sp_fwd(packed, key_bias, H, 0.0, 0)
    o11 = o11.permute(0, 2, 1, 3).reshape(B, T, H * 64)
    assert rel_err(o11, o1) < REL_TOL and rel_err(o13, o1) < REL_TOL


@pytest.mark.parametrize("variant", ["heads_major", "save_probs"])
def test_variant_autograd_through_kernels(cuda, variant):
    B, T, H, rate, seed = 2, 57, 2, 0.1, 3
    counters = (fa.heads_major_attention_fwd, fa.heads_major_attention_bwd) if variant == "heads_major" else (
        fa.packed_attention_sp_fwd, fa.packed_attention_sp_bwd)
    before = [c.launches for c in counters]
    if variant == "heads_major":
        qkv, key_bias, dout = heads_major_inputs(B, T, H, cuda, seed=1)
        x = qkv.clone().requires_grad_(True)
        fa.flash_attention_heads_major(x, key_bias, rate, seed).backward(dout)
        out_r, stats_r = fa.heads_major_attention_fwd_reference(qkv, key_bias, rate, seed)
        want = fa.heads_major_attention_bwd_reference(qkv, key_bias, dout, out_r, stats_r, rate, seed)
        grads = [(x.grad, want)]
    else:
        qkv, qb, key_bias, dout = attention_inputs(B, T, H, cuda, seed=1)
        x, b = qkv.clone().requires_grad_(True), qb.clone().requires_grad_(True)
        fa.flash_attention_packed(x, H, key_bias, rate, seed, qkv_bias=b, save_probs=True).backward(dout)
        out_r, probs_r = fa.packed_attention_sp_fwd_reference(qkv + qb, key_bias, H, rate, seed)
        want = fa.packed_attention_sp_bwd_reference(qkv + qb, probs_r, dout, out_r, H, rate, seed)
        grads = [(x.grad, want), (b.grad, want.float().sum(dim=(0, 1)))]
    assert [c.launches - n for c, n in zip(counters, before)] == [1, 1]
    for got, ref in grads:
        assert rel_err(got, ref) < REL_TOL


def test_variant_kernels_take_t_up_to_704_and_refuse_more(cuda):
    """K11/K12 and K13/K14 take T = 704 (the largest T whose 64-row tiles
    fit a block's shared memory) and refuse T = 1024 before launch."""
    qkv5, key_bias, dout5 = heads_major_inputs(1, 704, 1, cuda)
    out5, stats = fa.heads_major_attention_fwd(qkv5, key_bias, 0.1, 1)
    fa.heads_major_attention_bwd(qkv5, key_bias, dout5, out5, stats, 0.1, 1)
    qkv, _, key_bias, dout = attention_inputs(1, 704, 1, cuda)
    out, probs = fa.packed_attention_sp_fwd(qkv, key_bias, 1, 0.1, 1)
    fa.packed_attention_sp_bwd(qkv, probs, dout, out, 1, 0.1, 1)
    torch.cuda.synchronize()
    for smem in (fa._build.library().vb_attn_hm_smem_bytes, fa._build.library().vb_attn_sp_smem_bytes):
        assert smem(704) <= fa.MAX_SMEM_BYTES < smem(705)
    big, kb, bigd = heads_major_inputs(1, 1024, 1, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fa.heads_major_attention_fwd(big, kb, 0.0, 0)
    with pytest.raises(ValueError, match="shared memory"):
        fa.heads_major_attention_bwd(big, kb, bigd, bigd, kb.view(1, 1, -1), 0.0, 0)
    packed = big.permute(0, 3, 2, 1, 4).reshape(1, 1024, 192).contiguous()
    with pytest.raises(ValueError, match="shared memory"):
        fa.packed_attention_sp_fwd(packed, kb, 1, 0.0, 0)
    dout = torch.zeros((1, 1024, 64), dtype=torch.bfloat16, device=cuda)
    probs = torch.zeros((1, 1, 1024, 1024), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        fa.packed_attention_sp_bwd(packed, probs, dout, dout, 1, 0.0, 0)


def test_heads_major_kernels_repeat_bit_for_bit(cuda):
    qkv, key_bias, dout = heads_major_inputs(4, 228, 12, cuda)
    runs = []
    for _ in range(2):
        out, stats = fa.heads_major_attention_fwd(qkv, key_bias, 0.1, 7)
        runs.append((out, stats, fa.heads_major_attention_bwd(qkv, key_bias, dout, out, stats, 0.1, 7)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_heads_major_kernels_drop_the_plain_mask(cuda):
    """K11/K12's counterpart of test_attention_kernels_drop_the_plain_mask:
    with v[j] the j-th unit vector (T = 64 = D keys, no key padding) out[i,
    j] is the dropped, rescaled p[i, j], zero exactly where the plain mask
    drops (every p > 0); with dout[i] the i-th unit vector the dK/dV pass's
    dv[j, i] is the same p_d[i, j]."""
    B, T, H, rate, seed = 3, 64, 2, 0.1, 11
    rng = np.random.RandomState(5)
    qkv = torch.tensor(rng.randn(B, 3, H, T, 64), dtype=torch.bfloat16, device=cuda)
    eye = torch.eye(T, dtype=torch.bfloat16, device=cuda)
    qkv[:, 2] = eye
    key_bias = torch.zeros((B, T), device=cuda)
    dout = eye.expand(B, H, T, 64).contiguous()
    out, stats = fa.heads_major_attention_fwd(qkv, key_bias, rate, seed)
    dqkv = fa.heads_major_attention_bwd(qkv, key_bias, dout, out, stats, rate, seed)
    torch.cuda.synchronize()
    keep = fa.attention_keep_reference(seed, B, H, T, rate, cuda)  # [B, H, i, j]
    dv = dqkv[:, 2].transpose(-1, -2)  # [B, H, i, j] = dv[j, i]
    assert 0.05 < 1 - float(keep.float().mean()) < 0.15
    assert torch.equal(out != 0, keep)
    assert torch.equal(dv != 0, keep)


@pytest.mark.parametrize("B,T,H", [(4, 228, 12), (2, 37, 3), (3, 130, 4), (1, 704, 2)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_heads_major_kernels_equal_the_packed_kernels_bit_for_bit(cuda, B, T, H, rate):
    """K11/K12 are K1/K2's kernels on another layout: on the same numbers,
    with K1/K2's deferred bias zero (bf16 x + 0 is exact), out, stats and
    dqkv agree bit for bit."""
    qkv5, key_bias, dout5 = heads_major_inputs(B, T, H, cuda, seed=4)
    packed = qkv5.permute(0, 3, 2, 1, 4).reshape(B, T, 3 * H * 64).contiguous()
    dout = dout5.permute(0, 2, 1, 3).reshape(B, T, H * 64).contiguous()
    qb = torch.zeros(3 * H * 64, dtype=torch.bfloat16, device=cuda)
    o1, s1 = fa.packed_attention_fwd(packed, qb, key_bias, H, rate, 5)
    d2, _ = fa.packed_attention_bwd(packed, qb, key_bias, dout, o1, s1, H, rate, 5)
    o11, s11 = fa.heads_major_attention_fwd(qkv5, key_bias, rate, 5)
    d12 = fa.heads_major_attention_bwd(qkv5, key_bias, dout5, o11, s11, rate, 5)
    torch.cuda.synchronize()
    assert torch.equal(o11.permute(0, 2, 1, 3).reshape(B, T, H * 64), o1)
    assert torch.equal(s11, s1)
    assert torch.equal(d12.permute(0, 3, 2, 1, 4).reshape(B, T, 3 * H * 64), d2)


def test_save_probs_kernels_repeat_bit_for_bit(cuda):
    qkv, qb, key_bias, dout = attention_inputs(4, 228, 12, cuda)
    qkv = qkv + qb
    runs = []
    for _ in range(2):
        out, probs = fa.packed_attention_sp_fwd(qkv, key_bias, 12, 0.1, 7)
        runs.append((out, probs, fa.packed_attention_sp_bwd(qkv, probs, dout, out, 12, 0.1, 7)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_save_probs_kernels_drop_the_plain_mask(cuda):
    """K13/K14's counterpart of test_attention_kernels_drop_the_plain_mask:
    with v[j] the j-th unit vector (T = 64 = D keys, no key padding, no
    bias) out[i, j] is the dropped, rescaled p[i, j], zero exactly where the
    plain mask drops (every p > 0); with dout[i] the i-th unit vector K14's
    dv[j, i], from K13's own probabilities, is the same p_d[i, j]."""
    B, T, H, rate, seed = 3, 64, 2, 0.1, 11
    rng = np.random.RandomState(5)
    qkv = torch.tensor(rng.randn(B, T, H, 3, 64), dtype=torch.bfloat16, device=cuda)
    qkv[:, :, :, 2] = torch.eye(T, dtype=torch.bfloat16, device=cuda)[None, :, None]
    qkv = qkv.reshape(B, T, 3 * H * 64).contiguous()
    key_bias = torch.zeros((B, T), device=cuda)
    dout = torch.eye(T, dtype=torch.bfloat16, device=cuda)[None, :, None].expand(B, T, H, 64).reshape(B, T, H * 64)
    out, probs = fa.packed_attention_sp_fwd(qkv, key_bias, H, rate, seed)
    dqkv = fa.packed_attention_sp_bwd(qkv, probs, dout.contiguous(), out, H, rate, seed)
    torch.cuda.synchronize()
    keep = fa.attention_keep_reference(seed, B, H, T, rate, cuda)  # [B, H, i, j]
    p_d = out.view(B, T, H, 64).permute(0, 2, 1, 3)  # [B, H, i, j]
    dv = dqkv.view(B, T, H, 3, 64)[:, :, :, 2].permute(0, 2, 3, 1)  # [B, H, i, j] = dv[j, i]
    assert 0.05 < 1 - float(keep.float().mean()) < 0.15
    assert bool((probs.float() > 0).all())
    assert torch.equal(p_d != 0, keep)
    assert torch.equal(dv != 0, keep)


@pytest.mark.parametrize("B,T,H", [(2, 37, 3), (4, 228, 12), (2, 272, 12), (3, 1, 2)])
def test_save_probs_backward_reads_any_layout_alike(cuda, B, T, H):
    """K14 gives the same dqkv, bit for bit, from K13's padded-stride
    probabilities and from a contiguous copy of them (copied into K13's
    layout where T % 8 != 0, read in place where T % 8 == 0)."""
    qkv, qb, key_bias, dout = attention_inputs(B, T, H, cuda)
    qkv = qkv + qb
    out, probs = fa.packed_attention_sp_fwd(qkv, key_bias, H, 0.1, 4)
    flat = probs.contiguous()
    assert (fa.probs_layout(flat, B, H, T) is None) == (T % 8 != 0)
    a = fa.packed_attention_sp_bwd(qkv, probs, dout, out, H, 0.1, 4)
    b = fa.packed_attention_sp_bwd(qkv, flat, dout, out, H, 0.1, 4)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# every VARIANTS entry, plus prescale with nomax (the fourth forward
# instantiation) and a head group that does not divide H
EXP_VARIANTS = dict(ae.VARIANTS, prescale_nomax=dict(prescale=True, nomax=True), g5=dict(group=5))
EXP_SHAPES = [(4, 228, 12), (2, 37, 3), (3, 130, 4)]


def assert_attention_close(got_fwd, want_fwd, got_bwd, want_bwd):
    (out, stats), (out_r, stats_r) = got_fwd, want_fwd
    (dqkv, dqb), (dqkv_r, dqb_r) = got_bwd, want_bwd
    assert rel_err(out, out_r) < REL_TOL
    assert float((stats - stats_r).abs().max()) < STATS_ATOL
    assert rel_err(dqkv, dqkv_r) < REL_TOL
    assert rel_err(dqb, dqb_r) < REL_TOL


@pytest.mark.parametrize("B,T,H", EXP_SHAPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name", list(EXP_VARIANTS))
def test_attention_experiment_kernels_match_plain(cuda, name, B, T, H, rate):
    kw = EXP_VARIANTS[name] or {}
    bb = kw.get("bb", 1)
    qkv, qb, key_bias, dout = attention_inputs(-(-B // bb) * bb, T, H, cuda)
    launches = (ae.attn_exp_fwd.launches, ae.attn_exp_bwd.launches)
    got_fwd = ae.attn_exp_fwd(qkv, qb, key_bias, H, rate, 99, **kw)
    want_fwd = ae.attn_exp_fwd_reference(qkv, qb, key_bias, H, rate, 99, **kw)
    # the backward gets the plain forward's out and stats on both sides
    got_bwd = ae.attn_exp_bwd(qkv, qb, key_bias, dout, *want_fwd, H, rate, 99, **kw)
    want_bwd = ae.attn_exp_bwd_reference(qkv, qb, key_bias, dout, *want_fwd, H, rate, 99, **kw)
    torch.cuda.synchronize()
    assert (ae.attn_exp_fwd.launches - launches[0], ae.attn_exp_bwd.launches - launches[1]) == (1, 1)
    assert_attention_close(got_fwd, want_fwd, got_bwd, want_bwd)


HGRID_CASES = [(hg, B, T, H) for B, T, H in [(4, 228, 12), (2, 272, 12), (2, 37, 3)]
               for hg in range(1, H + 1) if H % hg == 0]


@pytest.mark.parametrize("hg,B,T,H", HGRID_CASES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_hgrid_kernels_match_plain(cuda, hg, B, T, H, rate):
    qkv, qb, key_bias, dout = attention_inputs(B, T, H, cuda)
    got_fwd = ae.attn_hgrid_fwd(qkv, qb, key_bias, H, rate, 99, hg)
    want_fwd = ae.attn_hgrid_fwd_reference(qkv, qb, key_bias, H, rate, 99, hg)
    assert got_fwd[1].shape == (B, H // hg, hg, T)
    got_bwd = ae.attn_hgrid_bwd(qkv, qb, key_bias, dout, *want_fwd, H, rate, 99, hg)
    want_bwd = ae.attn_hgrid_bwd_reference(qkv, qb, key_bias, dout, *want_fwd, H, rate, 99, hg)
    torch.cuda.synchronize()
    assert_attention_close(got_fwd, want_fwd, got_bwd, want_bwd)


NUMERICS = ("prescale", "nomax", "fdrop")
# the schedules without a numerics flag: each must be K1/K2 bit for bit
EXP_SCHEDULES = ([("attn_exp", name, kw or {}) for name, kw in ae.VARIANTS.items() if not set(kw or {}) & set(NUMERICS)]
                 + [("attn_hgrid", f"hg={hg}", dict(hg=hg)) for hg in (1, 2, 3, 4, 6, 12)])


@pytest.mark.parametrize("B,T", [(8, 228), (8, 37)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kernel,name,kw", EXP_SCHEDULES, ids=[n for _, n, _ in EXP_SCHEDULES])
def test_experiment_schedules_equal_k1_k2_bit_for_bit(cuda, kernel, name, kw, B, T, rate):
    """K15/K16 run K1/K2's tile code and sums in K1/K2's order whatever the
    schedule: out, stats and dqkv equal K1/K2's (the bias gradient is summed
    over other blocks and held to a tolerance elsewhere)."""
    H = 12
    qkv, qb, key_bias, dout = attention_inputs(B, T, H, cuda)
    o1, s1 = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 7)
    d2, _ = fa.packed_attention_bwd(qkv, qb, key_bias, dout, o1, s1, H, rate, 7)
    fwd, bwd = getattr(ae, kernel + "_fwd"), getattr(ae, kernel + "_bwd")
    o, s = fwd(qkv, qb, key_bias, H, rate, 7, **kw)
    d, _ = bwd(qkv, qb, key_bias, dout, o1, s1.view(s.shape), H, rate, 7, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o1)
    assert torch.equal(s.reshape(s1.shape), s1)
    assert torch.equal(d, d2)


EXP_FLAGS = {name: kw for name, kw in EXP_VARIANTS.items() if set(kw or {}) & set(NUMERICS)}


@pytest.mark.parametrize("T", [1, 37, 228, 272, "largest"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name", list(EXP_FLAGS))
def test_each_numerics_flag_matches_plain_at_every_t(cuda, name, T, rate):
    kw = EXP_FLAGS[name]
    if T == "largest":
        T = ae.PRESCALE_MAX_T if kw.get("prescale") else 704
    B, H = 2, 2
    qkv, qb, key_bias, dout = attention_inputs(B, T, H, cuda)
    # a row whose every key is masked (row 1 at T = 1) has no defined nomax
    # output: its sum underflows to 0 and out is 0 / 0 in the JAX variant
    # and the plain version alike, so every row keeps its first key
    key_bias[:, 0] = 0.0
    got_fwd = ae.attn_exp_fwd(qkv, qb, key_bias, H, rate, 99, **kw)
    want_fwd = ae.attn_exp_fwd_reference(qkv, qb, key_bias, H, rate, 99, **kw)
    got_bwd = ae.attn_exp_bwd(qkv, qb, key_bias, dout, *want_fwd, H, rate, 99, **kw)
    want_bwd = ae.attn_exp_bwd_reference(qkv, qb, key_bias, dout, *want_fwd, H, rate, 99, **kw)
    torch.cuda.synchronize()
    assert_attention_close(got_fwd, want_fwd, got_bwd, want_bwd)


def test_experiment_kernels_refuse_past_their_largest_t(cuda):
    """Prescale's dK/dV pass keeps a second, scaled copy of the queries: its
    backward takes T up to PRESCALE_MAX_T, the shared memory
    vb_attn_exp_info reports; every other kernel takes T up to 704."""
    lib = _build.library()
    assert lib.vb_attn_exp_info(2, 2, ae.PRESCALE_MAX_T, 1, 0) <= fa.MAX_SMEM_BYTES
    assert lib.vb_attn_exp_info(2, 2, ae.PRESCALE_MAX_T + 1, 1, 0) > fa.MAX_SMEM_BYTES
    assert lib.vb_attn_exp_smem_bytes(704) <= fa.MAX_SMEM_BYTES < lib.vb_attn_exp_smem_bytes(705)
    T = ae.PRESCALE_MAX_T + 1
    qkv, qb, key_bias, dout = attention_inputs(1, T, 1, cuda)
    out, stats = ae.attn_exp_fwd(qkv, qb, key_bias, 1, 0.1, 3, prescale=True)
    with pytest.raises(ValueError, match=f"T up to {ae.PRESCALE_MAX_T}"):
        ae.attn_exp_bwd(qkv, qb, key_bias, dout, out, stats, 1, 0.1, 3, prescale=True)
    qkv, qb, key_bias, dout = attention_inputs(1, 705, 1, cuda)
    with pytest.raises(ValueError, match="more shared memory"):
        ae.attn_hgrid_fwd(qkv, qb, key_bias, 1, 0.1, 3, 1)


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("prescale", [0, 1])
@pytest.mark.parametrize("flag", [0, 1])
def test_experiment_kernels_do_not_spill(cuda, which, prescale, flag):
    lib = _build.library()
    for T in (228, ae.PRESCALE_MAX_T if prescale else 704):
        regs, local, smem, per_sm = (lib.vb_attn_exp_info(which, w, T, prescale, flag) for w in range(4))
        assert 0 < regs <= 255 and local == 0 and 0 < smem <= fa.MAX_SMEM_BYTES and per_sm >= 1


@pytest.mark.parametrize("name", ["prescale_nomax", "fdrop_prescale", "nomax", "bb2_g6", "nostack", "g5"])
def test_experiment_kernels_repeat_bit_for_bit(cuda, name):
    kw = EXP_VARIANTS[name] or {}
    qkv, qb, key_bias, dout = attention_inputs(4, 228, 12, cuda)
    runs = []
    for _ in range(2):
        out, stats = ae.attn_exp_fwd(qkv, qb, key_bias, 12, 0.1, 7, **kw)
        dqkv, dqb = ae.attn_exp_bwd(qkv, qb, key_bias, dout, out, stats, 12, 0.1, 7, **kw)
        torch.cuda.synchronize()
        runs.append((out, stats, dqkv, dqb))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_attention_dropout_changes_output(cuda):
    qkv, qb, key_bias, _ = attention_inputs(2, 100, 2, cuda)
    o0, _ = fa.packed_attention_fwd(qkv, qb, key_bias, 2, 0.0, 5)
    o1, _ = fa.packed_attention_fwd(qkv, qb, key_bias, 2, 0.1, 5)
    o2, _ = fa.packed_attention_fwd(qkv, qb, key_bias, 2, 0.1, 5)
    o3, _ = fa.packed_attention_fwd(qkv, qb, key_bias, 2, 0.1, 6)
    assert torch.equal(o1, o2)
    assert not torch.equal(o0, o1)
    assert not torch.equal(o1, o3)


def test_autograd_through_kernels(cuda):
    qkv, qb, key_bias, dout = attention_inputs(2, 57, 2, cuda)
    x = qkv.clone().requires_grad_(True)
    b = qb.clone().requires_grad_(True)
    fa.flash_attention_packed(x, 2, key_bias, 0.1, 3, qkv_bias=b).backward(dout)
    xr = qkv.clone().requires_grad_(True)
    br = qb.clone().requires_grad_(True)
    fa.flash_attention_packed_reference(xr, 2, key_bias, 0.1, 3, qkv_bias=br).backward(dout)
    assert rel_err(x.grad, xr.grad) < REL_TOL
    assert rel_err(b.grad, br.grad) < REL_TOL


def test_f32_out_decoder_product(cuda):
    from visualbert_torch.models.heads import matmul_f32_out

    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(2, 24, 768), dtype=torch.bfloat16, device=cuda, requires_grad=True)
    w = torch.tensor(rng.randn(1000, 768) * 0.02, dtype=torch.float32, device=cuda, requires_grad=True)
    g = torch.tensor(rng.randn(2, 24, 1000), dtype=torch.float32, device=cuda)
    out = matmul_f32_out(x, w)
    assert out.dtype == torch.float32
    out.backward(g)
    xr = x.detach().float().requires_grad_(True)
    wr = w.detach().to(torch.bfloat16).float().requires_grad_(True)
    ref = xr @ wr.t()
    ref.backward(g.to(torch.bfloat16).float())
    assert rel_err(out, ref) < 1e-5
    assert rel_err(x.grad, xr.grad) < REL_TOL
    assert rel_err(w.grad, wr.grad) < REL_TOL


def xent_inputs(N, V, device, seed=0, H=768):
    """bf16 x and embedding, fp32 bias, int32 labels in [0, V) (15 % of them
    -1 before the clamp, with g = 0 there) and a non-uniform fp32 g."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(N, H), dtype=torch.bfloat16, device=device)
    emb = torch.tensor(rng.randn(V, H) * 0.05, dtype=torch.bfloat16, device=device)
    bias = torch.tensor(rng.randn(V) * 0.1, dtype=torch.float32, device=device)
    labels = rng.randint(0, V, N)
    labels[rng.rand(N) < 0.15] = -1
    g = np.where(labels >= 0, rng.uniform(0.5, 1.5, N), 0.0)
    return (x, emb, bias, torch.tensor(np.maximum(labels, 0), dtype=torch.int32, device=device),
            torch.tensor(g, dtype=torch.float32, device=device))


def top2_gap(x, emb, bias):
    top = torch.topk(xe._logits(x, emb, bias), 2, dim=-1).values
    return top[:, 0] - top[:, 1]


@pytest.mark.parametrize("N,V", [(3072, 30522), (100, 1000), (37, 30522), (257, 4099), (1, 70)])
def test_xent_kernels_match_plain(cuda, N, V):
    x, emb, bias, labels, g = xent_inputs(N, V, cuda)
    nll, lse, am = xe.mlm_xent_fwd(x, emb, bias, labels)
    nll_r, lse_r, am_r = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    torch.cuda.synchronize()
    assert float((nll - nll_r).abs().max()) < XENT_ATOL
    assert float((lse - lse_r).abs().max()) < XENT_ATOL
    clear = top2_gap(x, emb, bias) > ARGMAX_GAP
    assert torch.equal(am[clear], am_r[clear])
    # the backward gets the same lse on both sides
    dx = xe.mlm_xent_dx(x, emb, bias, labels, lse_r, g)
    de, db = xe.mlm_xent_de(x, emb, bias, labels, lse_r, g)
    dx_r = xe.mlm_xent_dx_reference(x, emb, bias, labels, lse_r, g)
    de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, labels, lse_r, g)
    torch.cuda.synchronize()
    assert dx.dtype == torch.bfloat16 and de.dtype == torch.bfloat16 and db.dtype == torch.float32
    assert rel_err(dx, dx_r) < REL_TOL
    assert rel_err(de, de_r) < REL_TOL
    assert rel_err(db, db_r) < DB_REL_TOL


@pytest.mark.parametrize("N", [3072, 37])
def test_xent_kernels_match_plain_at_bert_large_width(cuda, N):
    x, emb, bias, labels, g = xent_inputs(N, 30522, cuda, H=1024)
    nll, lse, am = xe.mlm_xent_fwd(x, emb, bias, labels)
    nll_r, lse_r, am_r = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    dx = xe.mlm_xent_dx(x, emb, bias, labels, lse_r, g)
    de, db = xe.mlm_xent_de(x, emb, bias, labels, lse_r, g)
    dx_r = xe.mlm_xent_dx_reference(x, emb, bias, labels, lse_r, g)
    de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, labels, lse_r, g)
    torch.cuda.synchronize()
    assert float((nll - nll_r).abs().max()) < XENT_ATOL and float((lse - lse_r).abs().max()) < XENT_ATOL
    clear = top2_gap(x, emb, bias) > ARGMAX_GAP
    assert torch.equal(am[clear], am_r[clear])
    assert dx.shape == (N, 1024) and de.shape == (30522, 1024)
    assert rel_err(dx, dx_r) < REL_TOL and rel_err(de, de_r) < REL_TOL and rel_err(db, db_r) < DB_REL_TOL


XENT_FWD_CASES = [(H, N, V) for H in (768, 1024) for N in (3072, 37, 257, 1, 65) for V in (30522, 4099, 70)]


@pytest.mark.parametrize("H,N,V", XENT_FWD_CASES)
def test_xent_forward_kernel_matches_plain(cuda, H, N, V):
    """K4 against its plain version where a row block (128 rows at 768, 64 at
    1024), a vocabulary tile (32 rows) and a split are ragged, single or
    whole: nll and lse within chip_smoke.py's 3e-5 absolute, the argmax equal
    wherever the plain top-2 gap exceeds 1e-3."""
    x, emb, bias, labels, _ = xent_inputs(N, V, cuda, seed=5, H=H)
    nll, lse, am = xe.mlm_xent_fwd(x, emb, bias, labels)
    nll_r, lse_r, am_r = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    torch.cuda.synchronize()
    assert nll.shape == lse.shape == am.shape == (N,)
    assert float((nll - nll_r).abs().max()) < 3e-5
    assert float((lse - lse_r).abs().max()) < 3e-5
    clear = top2_gap(x, emb, bias) > ARGMAX_GAP
    assert torch.equal(am[clear], am_r[clear])


@pytest.mark.parametrize("H", [768, 1024])
def test_xent_forward_kernel_repeats_bit_for_bit(cuda, H):
    """No atomics: the blocks' order cannot change a bit of nll, lse or the
    argmax."""
    x, emb, bias, labels, _ = xent_inputs(1000, 30522, cuda, seed=6, H=H)
    first = xe.mlm_xent_fwd(x, emb, bias, labels)
    again = xe.mlm_xent_fwd(x, emb, bias, labels)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("H", [768, 1024])
def test_xent_forward_kernel_does_not_spill(cuda, H):
    from visualbert_torch.ops import _build

    lib = _build.library()
    regs, local, smem, per_sm = (lib.vb_xent_info(2, w, H) for w in range(4))
    assert 0 < regs <= 255 and local == 0
    assert 0 < smem <= 232448 and per_sm == 1


XENT_BWD_CASES = ([(768, N, V) for N in (3072, 37, 257, 1, 65) for V in (30522, 4099, 70)]
                  + [(1024, N, V) for N in (3072, 37) for V in (30522, 4099, 70)])


@pytest.mark.parametrize("H,N,V", XENT_BWD_CASES)
def test_xent_backward_kernels_match_plain(cuda, H, N, V):
    """K5/K6 against their plain versions where a row block, a vocabulary
    tile and a split are ragged, single or whole (the vocabulary tile is 32
    rows at 768 and 64 at 1024, the row block 64)."""
    x, emb, bias, labels, g = xent_inputs(N, V, cuda, seed=3, H=H)
    _, lse_r, _ = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    dx = xe.mlm_xent_dx(x, emb, bias, labels, lse_r, g)
    de, db = xe.mlm_xent_de(x, emb, bias, labels, lse_r, g)
    dx_r = xe.mlm_xent_dx_reference(x, emb, bias, labels, lse_r, g)
    de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, labels, lse_r, g)
    torch.cuda.synchronize()
    assert dx.shape == (N, H) and de.shape == (V, H) and db.shape == (V,)
    assert rel_err(dx, dx_r) < REL_TOL
    assert rel_err(de, de_r) < REL_TOL
    assert rel_err(db, db_r) < DB_REL_TOL


@pytest.mark.parametrize("H", [768, 1024])
def test_xent_backward_kernels_repeat_bit_for_bit(cuda, H):
    """No atomics: the blocks' order cannot change a bit of dx, dE or db."""
    x, emb, bias, labels, g = xent_inputs(1000, 30522, cuda, seed=4, H=H)
    _, lse, _ = xe.mlm_xent_fwd(x, emb, bias, labels)
    first = (xe.mlm_xent_dx(x, emb, bias, labels, lse, g),) + xe.mlm_xent_de(x, emb, bias, labels, lse, g)
    again = (xe.mlm_xent_dx(x, emb, bias, labels, lse, g),) + xe.mlm_xent_de(x, emb, bias, labels, lse, g)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("H", [768, 1024])
@pytest.mark.parametrize("kernel", [0, 1])
def test_xent_backward_kernels_do_not_spill(cuda, kernel, H):
    from visualbert_torch.ops import _build

    lib = _build.library()
    regs, local, smem, per_sm = (lib.vb_xent_info(kernel, w, H) for w in range(4))
    assert 0 < regs <= 255 and local == 0
    assert 0 < smem <= 232448 and per_sm == 1


def test_xent_geometry_is_the_one_the_plans_are_tested_with(cuda):
    """tests/test_torch_xent_geometry.py holds the grid plans at this tiling."""
    from visualbert_torch.ops import _build

    lib = _build.library()
    got = {H: tuple(lib.vb_xent_geometry(w, H) for w in range(6)) for H in xe.KERNEL_WIDTHS}
    assert got == {128: (128, 128, 64, 32, 32, 128), 256: (256, 128, 64, 32, 32, 256),
                   512: (512, 128, 64, 32, 32, 512), 768: (768, 128, 64, 32, 32, 768),
                   1024: (1024, 64, 64, 32, 64, 512)}
    assert lib.vb_xent_geometry(0, 640) == -1 and lib.vb_xent_info(0, 0, 640) == -1
    assert lib.vb_xent_info(2, 0, 640) == -1 and lib.vb_xent_info(3, 0, 768) == -1
    assert lib.vb_xent_f16_info(2, 0, 640) == -1 and lib.vb_xent_f32_info(0, 0, 0) == -1
    # tests/test_torch_xent_wide.py plans the fp32 and the wide grids at these
    assert (lib.vb_xent_f32_geometry(0), lib.vb_xent_f32_geometry(1)) == (128, 256)
    assert tuple(lib.vb_xent_wide_geometry(w) for w in range(7)) == (64, 128, 64, 128, 64, 512, 16)
    assert tuple(lib.vb_xent_f16_wide_geometry(w) for w in range(7)) == (64, 128, 64, 128, 64, 512, 16)
    for info in (lib.vb_xent_wide_info, lib.vb_xent_f16_wide_info):
        assert info(0, 0, 1024) == -1 and info(2, 0, 1100) == -1
        assert info(2, 0, 1088) > 0 and info(3, 0, 2048) == -1


def test_xent_argmax_takes_the_first_max(cuda):
    """Equal logits in one vocabulary tile (5, 9) and in two splits (5,
    V - 3): the lower index wins, as torch.argmax and the TPU kernel."""
    N, V = 8, 30522
    x, emb, bias, labels, _ = xent_inputs(N, V, cuda, seed=1)
    u = emb[5].float() * 40
    for v in (5, 9, V - 3):
        emb[v] = u.to(torch.bfloat16)
        bias[v] = 0.25
    x[:] = emb[5]
    _, _, am = xe.mlm_xent_fwd(x, emb, bias, labels)
    assert am.tolist() == [5] * N


def test_xent_autograd_through_kernels(cuda):
    N, V = 300, 5000
    x, emb, bias, labels, g = xent_inputs(N, V, cuda, seed=2)
    lab = labels.long()
    lab[g == 0] = -1
    xg = x.clone().requires_grad_(True)
    eg = emb.float().requires_grad_(True)  # the fp32 parameter; the op casts it
    bg = bias.clone().requires_grad_(True)
    counts = [f.launches for f in (xe.mlm_xent_fwd, xe.mlm_xent_dx, xe.mlm_xent_de)]
    nll, am = xe.mlm_xent(xg, eg, bg, lab)
    (nll * g).sum().backward()
    assert [f.launches - c for f, c in zip((xe.mlm_xent_fwd, xe.mlm_xent_dx, xe.mlm_xent_de), counts)] == [1, 1, 1]
    nll_r, lse_r, _ = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, labels, lse_r, g)
    assert float((nll.detach() - nll_r).abs().max()) < XENT_ATOL
    assert xg.grad.dtype == torch.bfloat16 and eg.grad.dtype == torch.float32
    assert rel_err(xg.grad, xe.mlm_xent_dx_reference(x, emb, bias, labels, lse_r, g)) < REL_TOL
    assert rel_err(eg.grad, de_r) < REL_TOL
    assert rel_err(bg.grad, db_r) < DB_REL_TOL


def test_xent_rejects_what_the_kernel_does_not_take(cuda):
    """x and E of different widths (every width runs, padded where needed)
    or dtypes, labels not int32."""
    x, emb, bias, labels, _ = xent_inputs(16, 100, cuda)
    wide = torch.zeros((16, 1100), dtype=x.dtype, device=cuda)
    with pytest.raises(ValueError, match="hidden width"):
        xe.mlm_xent_fwd(wide, torch.zeros((100, 1000), dtype=x.dtype, device=cuda), bias, labels)
    with pytest.raises(ValueError, match="bf16"):
        xe.mlm_xent_fwd(x.float(), emb, bias, labels)
    with pytest.raises(ValueError, match="int32"):
        xe.mlm_xent_fwd(x, emb, bias, labels.long())


def test_model_step_kernels_match_plain_with_dropout(cuda, monkeypatch):
    """Two layers at bert-base width, dropout on, every kernel of the main
    path (K1-K6): the train step through the kernels and through their plain
    versions draws the same masks (the plain versions are bit-exact twins),
    so loss and gradients agree."""
    from visualbert_torch.config import VisualBertConfig
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.synth import synth_batch
    from visualbert_torch.train.trainer import to_device

    cfg = VisualBertConfig.base(use_flash_attention=True, fast_dropout=True, fused_mlm_xent=True,
                                num_hidden_layers=2)
    batch = to_device(synth_batch(4, seed=2), cuda)
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(fa, "packed_attention_fwd", fa.packed_attention_fwd_reference)
            monkeypatch.setattr(fa, "packed_attention_bwd", fa.packed_attention_bwd_reference)
            monkeypatch.setattr(dropout_ops, "dropout_mask", dropout_ops.dropout_mask_reference)
            monkeypatch.setattr(dropout_ops, "dropout_fwd", dropout_ops.dropout_fwd_reference)
            monkeypatch.setattr(dropout_ops, "dropout_bwd", dropout_ops.dropout_bwd_reference)
            for k in ("fwd", "dx", "de"):
                monkeypatch.setattr(xe, f"mlm_xent_{k}", getattr(xe, f"mlm_xent_{k}_reference"))
        model = VisualBertForTask(cfg, "pretraining").init_weights(torch.Generator().manual_seed(0)).to(cuda)
        out = model(batch, torch.Generator().manual_seed(7))
        out["loss"].backward()
        runs.append((float(out["loss"]), {k: p.grad.float() for k, p in model.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = runs
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    bad = {}
    for k in grads_p:
        if k.endswith("attention.self.key.bias"):
            # identically zero in exact arithmetic (a per-query constant
            # under the softmax); both sides are rounding noise
            assert float(grads_k[k].abs().max()) < 1e-5 and float(grads_p[k].abs().max()) < 1e-5
            continue
        err = rel_err(grads_k[k], grads_p[k])
        if not err < 5e-2:
            bad[k] = err
    assert not bad, bad


@pytest.mark.parametrize("flags", [dict(packed_qkv=False), dict(flash_save_probs=True)],
                         ids=["packed_qkv_false", "flash_save_probs"])
def test_model_step_with_attention_variants_matches_plain(cuda, monkeypatch, flags):
    """Two layers at bert-base width, dropout on, through K11/K12 or K13/K14
    and through their plain versions (the same masks): loss and gradients
    agree."""
    from visualbert_torch.config import VisualBertConfig
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.synth import synth_batch
    from visualbert_torch.train.trainer import to_device

    cfg = VisualBertConfig.base(use_flash_attention=True, num_hidden_layers=2, **flags)
    batch = to_device(synth_batch(4, seed=2), cuda)
    names = ("heads_major_attention_fwd", "heads_major_attention_bwd", "packed_attention_sp_fwd",
             "packed_attention_sp_bwd")
    runs = []
    for plain in (False, True):
        if plain:
            for k in names:
                monkeypatch.setattr(fa, k, getattr(fa, k + "_reference"))
        counts = [getattr(getattr(fa, k), "launches", 0) for k in names]
        model = VisualBertForTask(cfg, "pretraining").init_weights(torch.Generator().manual_seed(0)).to(cuda)
        out = model(batch, torch.Generator().manual_seed(7))
        out["loss"].backward()
        if not plain:
            want = [2, 2, 0, 0] if flags.get("packed_qkv") is False else [0, 0, 2, 2]
            assert [getattr(fa, k).launches - c for k, c in zip(names, counts)] == want
        runs.append((float(out["loss"]), {k: p.grad.float() for k, p in model.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = runs
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    bad = {}
    for k in grads_p:
        if k.endswith("attention.self.key.bias"):
            assert float(grads_k[k].abs().max()) < 1e-5 and float(grads_p[k].abs().max()) < 1e-5
            continue
        err = rel_err(grads_k[k], grads_p[k])
        if not err < 5e-2:
            bad[k] = err
    assert not bad, bad


def ln_inputs(N, H, device, dtype=torch.bfloat16, seed=0):
    rng = np.random.RandomState(seed)
    x, res, dy = (torch.tensor(rng.randn(N, H), dtype=dtype, device=device) for _ in range(3))
    scale = torch.tensor(1.0 + 0.1 * rng.randn(H), dtype=torch.float32, device=device)
    bias = torch.tensor(0.1 * rng.randn(H), dtype=torch.float32, device=device)
    return x, res, dy, scale, bias


def assert_fwd_close(got, want):
    """(y, mu, rstd) against the plain version."""
    assert got[0].dtype == want[0].dtype and rel_err(got[0], want[0]) < REL_TOL
    for a, b in zip(got[1:], want[1:]):
        assert float((a - b).abs().max()) < STATS_ATOL


def assert_bwd_close(got, want):
    """(dx, [dres,] dscale, dbias) against the plain version."""
    got, want = list(got), list(want)
    for a, b in zip(got[:-2], want[:-2]):
        assert a.dtype == b.dtype and rel_err(a, b) < REL_TOL
    for a, b in zip(got[-2:], want[-2:]):
        assert a.dtype == torch.float32 and rel_err(a, b) < DB_REL_TOL


@pytest.mark.parametrize("N,H", [(29184, 768), (37, 64), (1, 768), (1001, 256)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_layer_norm_kernels_match_plain(cuda, N, H, rate):
    x, res, dy, scale, bias = ln_inputs(N, H, cuda)
    if rate == 0.0:  # K7/K8
        fwd = ln.add_layer_norm_fwd(x, res, scale, bias)
        fwd_r = ln.add_layer_norm_fwd_reference(x, res, scale, bias)
        _, mu, rstd = fwd_r
        bwd = ln.add_layer_norm_bwd(x, res, scale, mu, rstd, dy)
        bwd_r = ln.add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy)
        torch.cuda.synchronize()
        assert_fwd_close(fwd, fwd_r)
        assert_bwd_close(bwd, bwd_r)
    # K9/K10, at rate 0 the same function as K7/K8
    fwd = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, rate, 77)
    fwd_r = ln.dropout_add_layer_norm_fwd_reference(x, res, scale, bias, rate, 77)
    _, mu, rstd, bits = fwd_r
    bwd = ln.dropout_add_layer_norm_bwd(x, res, scale, mu, rstd, dy, fwd[3], rate)
    bwd_r = ln.dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, bits, rate)
    torch.cuda.synchronize()
    assert_fwd_close(fwd[:3], fwd_r[:3])
    assert torch.equal(fwd[3], bits)
    assert_bwd_close(bwd, bwd_r)
    assert torch.equal(bwd[0] == 0, bwd_r[0] == 0)  # the same dropped positions


LN_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


@pytest.mark.parametrize("N", [29184, 17408, 1, 37, 1001, 4099])
@pytest.mark.parametrize("H", [768, 1024, 256, 64, 200])
@pytest.mark.parametrize("dtype", list(LN_DTYPES), ids=str)
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_layer_norm_kernels_match_plain(cuda, N, H, dtype, rate):
    """K9's bits are the plain bits (K3's mask, packed) exactly; K10 on them
    matches its plain version, at the main path's rows, NLVR2's, rows that
    leave a warp's ring partly filled, widths whose bits rows are no
    multiple of 16 bytes (64, 200) or 4 (200: 25 bytes a row, so rows start
    at every byte offset of a word), and every dtype; dx is zero at every
    dropped position, and elsewhere only where a value underflows."""
    x, res, dy, scale, bias = ln_inputs(N, H, cuda, dtype=dtype, seed=5)
    fwd = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, rate, 123)
    fwd_r = ln.dropout_add_layer_norm_fwd_reference(x, res, scale, bias, rate, 123)
    _, mu, rstd, bits = fwd_r
    torch.cuda.synchronize()
    assert fwd[3].shape == (N, H // 8) and fwd[3].dtype == torch.uint8 and torch.equal(fwd[3], bits)
    assert_fwd_close(fwd[:3], fwd_r[:3])
    bwd = ln.dropout_add_layer_norm_bwd(x, res, scale, mu, rstd, dy, fwd[3], rate)
    bwd_r = ln.dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, bits, rate)
    torch.cuda.synchronize()
    assert_bwd_close(bwd, bwd_r)
    dropped = ~ln.unpack_bits(bits)
    assert not bool(bwd[0][dropped].any()) and not bool(bwd_r[0][dropped].any())
    # a kept dx is zero on one side only where it underflows (fp16 below 2^-24)
    differ = (bwd[0] == 0) != (bwd_r[0] == 0)
    largest = torch.maximum(bwd[0].float().abs(), bwd_r[0].float().abs())[differ]
    assert largest.numel() == 0 or float(largest.max()) < torch.finfo(dtype).tiny


@pytest.mark.parametrize("N,H", [(29184, 768), (4099, 200), (37, 1024)])
def test_layer_norm_kernels_repeat_bit_for_bit(cuda, N, H):
    """No atomics, and the grid is fixed for a card and shape: K7-K10 give
    the same bits twice."""
    x, res, dy, scale, bias = ln_inputs(N, H, cuda, seed=6)
    runs = []
    for _ in range(2):
        y7, mu, rstd = ln.add_layer_norm_fwd(x, res, scale, bias)
        k8 = ln.add_layer_norm_bwd(x, res, scale, mu, rstd, dy)
        k9 = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, 0.1, 3)
        k10 = ln.dropout_add_layer_norm_bwd(x, res, scale, k9[1], k9[2], dy, k9[3], 0.1)
        runs.append((y7, mu, rstd) + tuple(k8) + tuple(k9) + tuple(k10))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("H", [64, 200, 256, 768, 1024])
@pytest.mark.parametrize("dtype", list(LN_DTYPES), ids=str)
def test_layer_norm_kernels_do_not_spill(cuda, dtype, H):
    """K7-K10 keep every value in registers (no local memory) and fit at
    least one block an SM; the backward's shared memory is its ring's."""
    from visualbert_torch.ops import _build

    lib = _build.library()
    for kernel in (7, 8, 9, 10):
        regs, local, smem, per_sm = (lib.vb_ln_info(kernel, w, H, LN_DTYPES[dtype]) for w in range(4))
        assert 0 < regs <= 255 and local == 0, (kernel, regs, local)
        assert per_sm >= 1 and 0 <= smem <= 232448
        assert (smem > 0) == (kernel in (8, 10))
    assert lib.vb_ln_info(10, 0, 4104, 0) == -1 and lib.vb_ln_info(11, 0, 768, 0) == -1
    assert lib.vb_ln_info(10, 5, 768, 0) == -1 and lib.vb_ln_info(10, 0, 768, 3) == -1


@pytest.fixture(scope="module")
def ln_step_builds():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from visualbert_torch.tools import ln_steps

    return ln_steps.build_all()[0]


@pytest.mark.parametrize("N,H", [(4099, 768), (37, 200), (1, 1024)])
@pytest.mark.parametrize("name", ["regen mask", "sync loads"])
def test_ln_step_builds_equal_the_kernels(cuda, ln_step_builds, name, N, H):
    """tools/ln_steps.py's builds of csrc/layer_norm.cu that draw the mask
    again from the seed or copy rows synchronously give K8's and K10's
    outputs bit for bit."""
    from visualbert_torch.ops import _build
    from visualbert_torch.tools import ln_steps

    sms = _build.sm_count(cuda)
    x, res, dy, scale, bias = ln_inputs(N, H, cuda, seed=7)
    _, mu, rstd, bits = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, ln_steps.RATE, ln_steps.SEED)
    runs = []
    for b in (ln_steps.Build("as built", _build.library()), ln_step_builds[name]):
        runs.append(b.bwd(x, res, scale, mu, rstd, dy, bits, True, sms)
                    + b.bwd(x, res, scale, mu, rstd, dy, None, False, sms))
    torch.cuda.synchronize()
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32])
def test_layer_norm_kernels_take_fp16_and_fp32(cuda, dtype):
    x, res, dy, scale, bias = ln_inputs(300, 512, cuda, dtype=dtype, seed=1)
    fwd = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, 0.2, 5)
    fwd_r = ln.dropout_add_layer_norm_fwd_reference(x, res, scale, bias, 0.2, 5)
    _, mu, rstd, bits = fwd_r
    bwd = ln.dropout_add_layer_norm_bwd(x, res, scale, mu, rstd, dy, fwd[3], 0.2)
    bwd_r = ln.dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, bits, 0.2)
    torch.cuda.synchronize()
    assert_fwd_close(fwd[:3], fwd_r[:3])
    assert torch.equal(fwd[3], bits)
    assert_bwd_close(bwd, bwd_r)


def test_layer_norm_dropout_mask_is_k3s(cuda):
    """K9 drops exactly K3's zeros: where the mask keeps, y is the plain
    add + LayerNorm of x / (1 - rate) + res; the same seed repeats; and the
    bits it saves are K3's mask packed."""
    x, res, _, scale, bias = ln_inputs(64, 768, cuda, seed=2)
    keep = ln.keep_mask(x.shape, 0.1, 9, cuda)
    assert torch.equal(keep, dropout_mask((64, 768), 0.1, 9, torch.int8, cuda).bool())
    y, _, _, bits = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, 0.1, 9)
    y2, _, _, _ = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, 0.1, 9)
    y3, _, _, _ = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, 0.1, 10)
    want = ln.reference_add_layer_norm(torch.where(keep, x.float() / 0.9, 0.0), res.float(), scale, bias)
    assert torch.equal(y, y2) and not torch.equal(y, y3)
    assert rel_err(y, want) < REL_TOL
    assert torch.equal(bits, ln.pack_bits(keep)) and torch.equal(ln.unpack_bits(bits), keep)


@pytest.mark.parametrize("dropout", [False, True])
def test_layer_norm_autograd_through_kernels(cuda, dropout):
    rate = 0.1 if dropout else 0.0
    x, res, dy, scale, bias = ln_inputs(4 * 57, 768, cuda, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (x.view(4, 57, 768), res.view(4, 57, 768), scale, bias)]
    wrappers = (ln.add_layer_norm_fwd, ln.add_layer_norm_bwd, ln.dropout_add_layer_norm_fwd,
                ln.dropout_add_layer_norm_bwd)
    counts = [w.launches for w in wrappers]
    if dropout:
        y = ln.fused_dropout_add_layer_norm(*leaves, 11, rate)
    else:
        y = ln.fused_add_layer_norm(*leaves)
    y.backward(dy.view(4, 57, 768))
    assert [w.launches - c for w, c in zip(wrappers, counts)] == ([0, 0, 1, 1] if dropout else [1, 1, 0, 0])
    y_r, mu, rstd, bits = ln.dropout_add_layer_norm_fwd_reference(x, res, scale, bias, rate, 11)
    assert rel_err(y.view(-1, 768), y_r) < REL_TOL
    want = ln.dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, bits, rate)
    assert_bwd_close([t.grad.reshape(w.shape) for t, w in zip(leaves, want)], want)


def test_layer_norm_rejects_what_the_kernel_does_not_take(cuda):
    x, res, dy, scale, bias = ln_inputs(16, 768, cuda)
    with pytest.raises(ValueError, match="up to 4096"):
        wide = torch.zeros(4, 4104, dtype=torch.bfloat16, device=cuda)
        ln.add_layer_norm_fwd(wide, wide, torch.ones(4104, device=cuda), torch.zeros(4104, device=cuda))
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(16 * 768 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(16, 768)
        ln.add_layer_norm_fwd(flat, res, scale, bias)
    with pytest.raises(ValueError, match="one dtype"):
        ln.add_layer_norm_fwd(x.double(), res.double(), scale, bias)
    with pytest.raises(ValueError, match="one dtype"):
        ln.add_layer_norm_fwd(x, res.float(), scale, bias)
    with pytest.raises(ValueError, match="contiguous"):
        ln.add_layer_norm_fwd(x.t().contiguous().t(), res, scale, bias)
    with pytest.raises(ValueError, match="float32"):
        ln.add_layer_norm_fwd(x, res, scale.to(torch.bfloat16), bias)
    with pytest.raises(ValueError, match=r"\[N, H\]"):
        ln.add_layer_norm_fwd(x.view(2, 8, 768), res.view(2, 8, 768), scale, bias)


def test_model_step_with_fused_layer_norm_matches_plain(cuda, monkeypatch):
    """Two layers at bert-base width, dropout on, use_fused_layer_norm: the
    train step through every kernel (K1-K3, K9/K10) and through their plain
    versions draws the same masks, so loss and gradients agree; and the
    dropout-free forward runs K7."""
    from visualbert_torch.config import VisualBertConfig
    from visualbert_torch.models.visualbert import VisualBertForTask
    from visualbert_torch.tools.synth import synth_batch
    from visualbert_torch.train.trainer import to_device

    cfg = VisualBertConfig.base(use_flash_attention=True, fast_dropout=True, fused_mlm_xent=True,
                                use_fused_layer_norm=True, num_hidden_layers=2)
    batch = to_device(synth_batch(4, seed=2), cuda)
    model = VisualBertForTask(cfg, "pretraining").init_weights(torch.Generator().manual_seed(0)).to(cuda)
    k7 = ln.add_layer_norm_fwd.launches
    with torch.no_grad():
        model(batch)
    assert ln.add_layer_norm_fwd.launches - k7 == 4
    runs = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(fa, "packed_attention_fwd", fa.packed_attention_fwd_reference)
            monkeypatch.setattr(fa, "packed_attention_bwd", fa.packed_attention_bwd_reference)
            monkeypatch.setattr(dropout_ops, "dropout_mask", dropout_ops.dropout_mask_reference)
            monkeypatch.setattr(dropout_ops, "dropout_fwd", dropout_ops.dropout_fwd_reference)
            monkeypatch.setattr(dropout_ops, "dropout_bwd", dropout_ops.dropout_bwd_reference)
            for k in ("fwd", "dx", "de"):
                monkeypatch.setattr(xe, f"mlm_xent_{k}", getattr(xe, f"mlm_xent_{k}_reference"))
            for k in ("add_layer_norm_fwd", "add_layer_norm_bwd", "dropout_add_layer_norm_fwd",
                      "dropout_add_layer_norm_bwd"):
                monkeypatch.setattr(ln, k, getattr(ln, k + "_reference"))
        model = VisualBertForTask(cfg, "pretraining").init_weights(torch.Generator().manual_seed(0)).to(cuda)
        k9 = getattr(ln.dropout_add_layer_norm_fwd, "launches", None)
        out = model(batch, torch.Generator().manual_seed(7))
        out["loss"].backward()
        if not plain:
            assert ln.dropout_add_layer_norm_fwd.launches - k9 == 4
        runs.append((float(out["loss"]), {k: p.grad.float() for k, p in model.named_parameters()}))
    (loss_k, grads_k), (loss_p, grads_p) = runs
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p)
    bad = {}
    for k in grads_p:
        if k.endswith("attention.self.key.bias"):
            assert float(grads_k[k].abs().max()) < 1e-5 and float(grads_p[k].abs().max()) < 1e-5
            continue
        err = rel_err(grads_k[k], grads_p[k])
        if not err < 5e-2:
            bad[k] = err
    assert not bad, bad


# --------------------------------------------------- the other forms of K1/K2, K4-K6

F32_REL_TOL = 1e-4  # fp32 forms: outputs and gradients, share of the largest plain value
F32_ABS_TOL = 1e-4  # fp32 forms: stats, nll, lse


def form_attention_inputs(B, T, H, D, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    F = 3 * H * D
    qkv = torch.tensor(rng.randn(B, T, F), dtype=dtype, device=device)
    qb = torch.tensor(rng.randn(F) * 0.1, dtype=dtype, device=device)
    mask = np.ones((B, T), np.float32)
    mask[0, T - T // 3:] = 0
    if B > 1:
        mask[1, -1:] = 0
    key_bias = torch.tensor((1.0 - mask) * -10000.0, device=device)
    dout = torch.tensor(rng.randn(B, T, H * D), dtype=dtype, device=device)
    return qkv, qb, key_bias, dout


FORM_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.mark.parametrize("B,T,H", [(2, 130, 4), (4, 228, 12), (1, 1, 2)])
@pytest.mark.parametrize("D", [8, 16, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("dtype", FORM_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_attention_forms_match_plain(cuda, dtype, D, B, T, H, rate):
    qkv, qb, key_bias, dout = form_attention_inputs(B, T, H, D, dtype, cuda)
    fwd = fa.packed_attention_fwd.forms.get(fa.attention_form(dtype, D), 0)
    out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, 99)
    out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 99)
    dqkv, dqb = fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
    dqkv_r, dqb_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
    torch.cuda.synchronize()
    assert fa.packed_attention_fwd.forms[fa.attention_form(dtype, D)] == fwd + 1
    assert out.dtype == dtype and out.shape == out_r.shape and dqkv.shape == qkv.shape and dqb.shape == qb.shape
    rel, st = (F32_REL_TOL, F32_ABS_TOL) if dtype == torch.float32 else (REL_TOL, STATS_ATOL)
    assert rel_err(out, out_r) < rel
    assert float((stats - stats_r).abs().max()) < st
    assert rel_err(dqkv, dqkv_r) < rel
    assert rel_err(dqb, dqb_r) < rel


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.bfloat16, 128), (torch.float16, 16),
                                     (torch.float32, 64), (torch.float32, 96), (torch.bfloat16, 16),
                                     (torch.bfloat16, 26), (torch.float16, 26), (torch.bfloat16, 32),
                                     (torch.float16, 32)], ids=str)
def test_attention_forms_repeat_bit_for_bit(cuda, dtype, D):
    qkv, qb, key_bias, dout = form_attention_inputs(4, 228, 6, D, dtype, cuda)
    runs = []
    for _ in range(2):
        out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, 6, 0.1, 7)
        runs.append((out, stats) + fa.packed_attention_bwd(qkv, qb, key_bias, dout, out, stats, 6, 0.1, 7))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.float16, 128), (torch.float32, 64),
                                     (torch.float32, 32), (torch.bfloat16, 128), (torch.float32, 16),
                                     (torch.float32, 30), (torch.float32, 99), (torch.float32, 100),
                                     (torch.bfloat16, 16), (torch.float16, 16), (torch.bfloat16, 32),
                                     (torch.float16, 32)], ids=str)
def test_attention_forms_drop_the_plain_mask(cuda, dtype, D):
    """As test_attention_kernels_drop_the_plain_mask, at T = D keys in every
    form: out[i, j] is the dropped p[i, j] and the dK/dV pass's dv[j, i] the
    same, zero exactly where the plain mask drops."""
    B, T, H, rate, seed = 3, D, 2, 0.1, 11
    rng = np.random.RandomState(5)
    qkv = torch.tensor(rng.randn(B, T, H, 3, D), dtype=dtype, device=cuda)
    qkv[:, :, :, 2] = torch.eye(T, dtype=dtype, device=cuda)[None, :, None]
    qkv = qkv.reshape(B, T, 3 * H * D).contiguous()
    qb = torch.zeros(3 * H * D, dtype=dtype, device=cuda)
    key_bias = torch.zeros((B, T), device=cuda)
    dout = torch.eye(T, dtype=dtype, device=cuda)[None, :, None].expand(B, T, H, D).reshape(B, T, H * D)
    out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, H, rate, seed)
    dqkv, _ = fa.packed_attention_bwd(qkv, qb, key_bias, dout.contiguous(), out, stats, H, rate, seed)
    torch.cuda.synchronize()
    keep = fa.attention_keep_reference(seed, B, H, T, rate, cuda)
    p_d = out.view(B, T, H, D).permute(0, 2, 1, 3)
    dv = dqkv.view(B, T, H, 3, D)[:, :, :, 2].permute(0, 2, 3, 1)
    assert torch.equal(p_d != 0, keep)
    assert torch.equal(dv != 0, keep)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_attention_at_head_dim_128_takes_t_up_to_256(cuda, dtype):
    """At D = 128 K1's forward holds a head's K/V rows, twice D = 64's
    shared memory: its longest T (above 256, the limit the backward's
    passes set before they streamed their tiles) runs and one more is
    refused with the limit named; K2's streamed passes hold no T's rows and
    take T past K1's limit (on the plain forward's outputs); fp32 has no
    such limit."""
    lib = _build.library()
    longest = max(t for t in range(1, 1024) if lib.vb_attn_packed_x_smem_bytes(128, t) <= fa.MAX_SMEM_BYTES)
    assert longest > 256
    qkv, qb, key_bias, dout = form_attention_inputs(1, longest, 2, 128, dtype, cuda)
    out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, 2, 0.0, 0)
    out_r, _ = fa.packed_attention_fwd_reference(qkv, qb, key_bias, 2, 0.0, 0)
    torch.cuda.synchronize()
    assert rel_err(out, out_r) < REL_TOL
    T = longest + 1
    qkv, qb, key_bias, dout = form_attention_inputs(1, T, 2, 128, dtype, cuda)
    with pytest.raises(ValueError, match=f"T up to {longest}"):
        fa.packed_attention_fwd(qkv, qb, key_bias, 2, 0.0, 0)
    out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, 2, 0.0, 0)
    dqkv, dqb = fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, 2, 0.0, 0)
    dqkv_r, dqb_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, 2, 0.0, 0)
    torch.cuda.synchronize()
    assert rel_err(dqkv, dqkv_r) < REL_TOL and rel_err(dqb, dqb_r) < REL_TOL
    qkv, qb, key_bias, dout = form_attention_inputs(1, 1024, 1, 128, torch.float32, cuda)
    out, stats = fa.packed_attention_fwd(qkv, qb, key_bias, 1, 0.0, 0)
    out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, 1, 0.0, 0)
    torch.cuda.synchronize()
    assert rel_err(out, out_r) < F32_REL_TOL and float((stats - stats_r).abs().max()) < F32_ABS_TOL


# ---- K2 at head dim 128 (bf16, fp16): the streamed two-warpgroup passes ----


@pytest.mark.parametrize("B,T,H", [(4, 228, 6), (2, 512, 4), (1, 1024, 3), (3, 37, 2), (2, 129, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_streamed_backward_at_head_dim_128_matches_plain(cuda, dtype, B, T, H, rate):
    """K2 at D = 128 (a block a 128 rows of one (batch row, head), K/V or
    Q/dO resident, the other operand streamed through a TMA ring into two
    consumer warpgroups) against its plain version within bf16's limits, at
    the main path's T = 228 and at T = 512 and 1024, past K1's limit (on the
    plain forward's outputs), with the bias gradient summed from the
    blocks' partials; two calls give the same bits."""
    qkv, qb, key_bias, dout = form_attention_inputs(B, T, H, 128, dtype, cuda)
    out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 99)
    form = fa.attention_form(dtype, 128)
    before = fa.packed_attention_bwd.forms.get(form, 0)
    runs = [fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99) for _ in range(2)]
    dqkv_r, dqb_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
    torch.cuda.synchronize()
    (dqkv, dqb), (dqkv2, dqb2) = runs
    assert fa.packed_attention_bwd.forms[form] == before + 2
    assert dqkv.dtype == dtype and dqkv.shape == qkv.shape and dqb.shape == qb.shape
    assert rel_err(dqkv, dqkv_r) < REL_TOL
    assert rel_err(dqb, dqb_r) < REL_TOL
    assert torch.equal(dqkv, dqkv2) and torch.equal(dqb, dqb2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_streamed_backward_at_head_dim_128_does_not_spill(cuda, dtype):
    """Both streamed passes keep every value in registers (two warpgroups,
    up to 255 a thread), one block an SM, the same shared memory at every T;
    their bias partials are one row a 128-row block, as the wrapper sizes
    them."""
    lib = _build.library()
    code = 0 if dtype == torch.bfloat16 else 1
    for which in (1, 2):
        regs, local, smem, per_sm = (lib.vb_attn_packed_x_info(code, 128, which, w, 228) for w in range(4))
        assert 0 < regs <= 255 and local == 0 and per_sm == 1, (which, regs, local, per_sm)
        assert lib.vb_attn_packed_x_info(code, 128, which, 2, 4096) == smem <= fa.MAX_SMEM_BYTES
    for T in (1, 128, 129, 228, 1024):
        assert lib.vb_attn_packed_x_bias_rows(128, T) == fa.packed_bias_rows(lib, 128, T) == -(-T // 128)
        assert lib.vb_attn_packed_x_bias_rows(64, T) == fa.packed_bias_rows(lib, 64, T) == 1


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8], ids=str)
def test_attention_forms_refuse_what_no_kernel_takes(cuda, dtype):
    if dtype == torch.float16:  # head dim 160 > 128
        qkv, qb, key_bias, _ = form_attention_inputs(1, 8, 1, 160, dtype, cuda)
        with pytest.raises(ValueError, match="head dims up to 128"):
            fa.packed_attention_fwd(qkv, qb, key_bias, 1, 0.0, 0)
        return
    qkv = torch.zeros((1, 8, 3 * 64), dtype=dtype, device=cuda)
    with pytest.raises(ValueError, match="bf16, fp16 or fp32"):
        fa.packed_attention_fwd(qkv, qkv[0, 0], torch.zeros((1, 8), device=cuda), 1, 0.0, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("which", [0, 1, 2])
def test_attention_half_forms_at_head_dim_64_do_not_spill(cuda, dtype, which):
    lib = _build.library()
    code = 0 if dtype == torch.bfloat16 else 1
    regs, local, smem, per_sm = (lib.vb_attn_packed_x_info(code, 64, which, w, 228) for w in range(4))
    assert 0 < regs <= 255 and local == 0 and per_sm >= 1


def form_xent_inputs(N, V, H, dtype, device, seed=0):
    x, emb, bias, labels, g = xent_inputs(N, V, device, seed=seed, H=H)
    return x.to(dtype), emb.to(dtype), bias, labels, g


XENT_FORM_CASES = ([(dt, H) for dt in (torch.bfloat16, torch.float16)
                    for H in (32, 64, 128, 200, 256, 384, 512, 640, 768, 1000, 1024, 1088, 2048, 2560)]
                   + [(torch.float32, H) for H in (32, 64, 200, 768, 1024, 1088, 2048)])


@pytest.mark.parametrize("N,V", [(257, 4099), (37, 30522), (1, 70)])
@pytest.mark.parametrize("dtype,H", XENT_FORM_CASES, ids=str)
def test_xent_forms_match_plain(cuda, dtype, H, N, V):
    x, emb, bias, labels, g = form_xent_inputs(N, V, H, dtype, cuda)
    nll, lse, am = xe.mlm_xent_fwd(x, emb, bias, labels)
    nll_r, lse_r, am_r = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    torch.cuda.synchronize()
    atol = F32_ABS_TOL if dtype == torch.float32 else XENT_ATOL
    assert float((nll - nll_r).abs().max()) < atol
    assert float((lse - lse_r).abs().max()) < atol
    clear = top2_gap(x, emb, bias) > ARGMAX_GAP
    assert torch.equal(am[clear], am_r[clear])
    dx = xe.mlm_xent_dx(x, emb, bias, labels, lse_r, g)
    de, db = xe.mlm_xent_de(x, emb, bias, labels, lse_r, g)
    dx_r = xe.mlm_xent_dx_reference(x, emb, bias, labels, lse_r, g)
    de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, labels, lse_r, g)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and de.dtype == dtype and dx.shape == x.shape and de.shape == emb.shape
    rel, db_rel = (F32_REL_TOL, F32_REL_TOL) if dtype == torch.float32 else (REL_TOL, DB_REL_TOL)
    assert rel_err(dx, dx_r) < rel
    assert rel_err(de, de_r) < rel
    assert rel_err(db, db_r) < db_rel


@pytest.mark.parametrize("dtype,H", [(torch.float16, 768), (torch.bfloat16, 256), (torch.bfloat16, 384),
                                     (torch.float32, 64), (torch.float32, 768), (torch.float32, 1088),
                                     (torch.float32, 2048), (torch.bfloat16, 2048), (torch.float16, 2560)], ids=str)
def test_xent_forms_repeat_bit_for_bit(cuda, dtype, H):
    x, emb, bias, labels, g = form_xent_inputs(3072, 30522, H, dtype, cuda)
    runs = []
    for _ in range(2):
        nll, lse, am = xe.mlm_xent_fwd(x, emb, bias, labels)
        runs.append((nll, lse, am, xe.mlm_xent_dx(x, emb, bias, labels, lse, g))
                    + xe.mlm_xent_de(x, emb, bias, labels, lse, g))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("info,H", [(i, H) for i in ("vb_xent_info", "vb_xent_f16_info") for H in xe.KERNEL_WIDTHS]
                         + [("vb_xent_f32_info", H) for H in (32, 768, 1024, 2048)])
@pytest.mark.parametrize("kernel", [0, 1, 2])
def test_xent_forms_do_not_spill(cuda, info, H, kernel):
    lib = _build.library()
    regs, local, smem, per_sm = (getattr(lib, info)(kernel, w, H) for w in range(4))
    assert 0 < regs <= 255 and local == 0
    assert 0 < smem <= 232448 and per_sm >= 1


@pytest.mark.parametrize("H", [1088, 1536, 2048, 2560, 4160, 8192])
@pytest.mark.parametrize("kernel", [0, 1, 2])
def test_xent_wide_forms_do_not_spill(cuda, H, kernel):
    lib = _build.library()
    regs, local, smem, per_sm = (lib.vb_xent_wide_info(kernel, w, H) for w in range(4))
    assert 0 < regs <= 255 and local == 0
    assert 0 < smem <= 232448 and per_sm >= 1


# 4160: a cluster of 9 blocks, past the portable 8; 6144 and 8192: 12 and 16, whose blocks sum 5 or 6 and 4 rows
WIDE_BWD_WIDTHS = (1088, 1536, 2048, 2560, 4160, 6144, 8192)


@pytest.mark.parametrize("N,V", [(N, V) for N in (1, 65, 3071) for V in (70, 4099, 30522)])
@pytest.mark.parametrize("H", WIDE_BWD_WIDTHS)
def test_xent_wide_backward_matches_plain(cuda, H, N, V):
    """The wide K5/K6 (a cluster of cdiv(H, 512) blocks forming each tile's
    logits once) against their plain versions at ragged rows, vocabulary
    tiles and splits: dx and dE at the bf16 limits of chip_smoke.py (1.2e-2,
    1.8e-2 of the largest plain value), db at this file's."""
    x, emb, bias, labels, g = xent_inputs(N, V, cuda, seed=11, H=H)
    _, lse, _ = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    dx = xe.mlm_xent_dx(x, emb, bias, labels, lse, g)
    de, db = xe.mlm_xent_de(x, emb, bias, labels, lse, g)
    dx_r = xe.mlm_xent_dx_reference(x, emb, bias, labels, lse, g)
    de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, labels, lse, g)
    torch.cuda.synchronize()
    assert xe.xent_form(x.dtype, H) == f"bf16 wide H{H}"
    assert rel_err(dx, dx_r) < 1.2e-2 and rel_err(de, de_r) < 1.8e-2 and rel_err(db, db_r) < DB_REL_TOL


@pytest.mark.parametrize("H", [512 * R for R in range(3, 17)] + [5696, 6720, 7232, 7744])
def test_xent_wide_backward_takes_every_cluster_size(cuda, H):
    """Every cluster of 3 to 16 blocks (each 512 columns, and at 5696-7744
    a last block of one panel) splits a tile's rows among its blocks and
    meets the plain versions, twice bit for bit."""
    x, emb, bias, labels, g = xent_inputs(65, 4099, cuda, seed=13, H=H)
    _, lse, _ = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    runs = [(xe.mlm_xent_dx(x, emb, bias, labels, lse, g),) + xe.mlm_xent_de(x, emb, bias, labels, lse, g)
            for _ in range(2)]
    dx_r = xe.mlm_xent_dx_reference(x, emb, bias, labels, lse, g)
    de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, labels, lse, g)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    dx, de, db = runs[0]
    assert rel_err(dx, dx_r) < 1.2e-2 and rel_err(de, de_r) < 1.8e-2 and rel_err(db, db_r) < DB_REL_TOL


@pytest.mark.parametrize("H", WIDE_BWD_WIDTHS)
def test_xent_wide_backward_repeats_bit_for_bit(cuda, H):
    """No atomics: the clusters' order and the exchange's timing cannot
    change a bit of dx, dE or db."""
    x, emb, bias, labels, g = xent_inputs(3071, 30522, cuda, seed=12, H=H)
    _, lse, _ = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    runs = [(xe.mlm_xent_dx(x, emb, bias, labels, lse, g),) + xe.mlm_xent_de(x, emb, bias, labels, lse, g)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("H", WIDE_BWD_WIDTHS)
def test_xent_wide_backward_clusters_fit_the_card(cuda, H):
    """The card runs some clusters of the wide K5 and K6 at once at every
    width the form takes (their shared memory, a block an SM); the wrapper
    plans K5's splits on that count; K4 has no cluster, and no width above
    8192 is taken."""
    lib = _build.library()
    for kernel in (0, 1):
        n = lib.vb_xent_wide_info(kernel, 4, H)
        assert n > 0 and xe.wide_clusters(lib, kernel, H) == n
        assert lib.vb_xent_wide_info(kernel, 3, H) == 1
    assert lib.vb_xent_wide_info(2, 4, H) == -1 and lib.vb_xent_wide_info(0, 4, 8256) == -1


@pytest.mark.parametrize("H", [1088, 1536, 2048, 2560, 4160, 8192])
@pytest.mark.parametrize("kernel", [0, 1, 2])
def test_xent_f16_wide_forms_do_not_spill(cuda, H, kernel):
    """The fp16 wide K5, K6 and K4 (vb_xent_f16_wide_info): no local memory,
    one block an SM, and (K5, K6) some clusters at once."""
    lib = _build.library()
    regs, local, smem, per_sm = (lib.vb_xent_f16_wide_info(kernel, w, H) for w in range(4))
    assert 0 < regs <= 255 and local == 0
    assert 0 < smem <= 232448 and per_sm == 1
    if kernel < 2:
        assert lib.vb_xent_f16_wide_info(kernel, 4, H) > 0
        assert xe.wide_clusters(lib, kernel, H, torch.float16) == lib.vb_xent_f16_wide_info(kernel, 4, H)


@pytest.mark.parametrize("N,V", [(N, V) for N in (1, 65, 3071) for V in (70, 4099, 30522)])
@pytest.mark.parametrize("H", WIDE_BWD_WIDTHS + (1100,))
def test_xent_f16_wide_forms_match_plain(cuda, H, N, V):
    """fp16 above 1024 on the wide form (not on the fp32 kernels): K4's nll
    and lse within chip_smoke.py's XENT_TOL (3e-5) of the exact products'
    (tools/xent_steps.py::fwd_exact: the plain version's own fp32 sums
    drift past it at 6144 and 8192) and its argmax where the top two
    logits are apart, K5's dx and K6's dE within the bf16 limits (1.2e-2,
    1.8e-2 of the largest plain value), db within this file's, at ragged
    rows, vocabulary tiles and splits and at a padded width (1100, run at
    1152)."""
    from visualbert_torch.tools.xent_steps import fwd_exact

    x, emb, bias, labels, g = form_xent_inputs(N, V, H, torch.float16, cuda, seed=17)
    assert xe.xent_form(x.dtype, H) == f"fp16 wide H{xe.kernel_width(H)}"
    nll, lse, am = xe.mlm_xent_fwd(x, emb, bias, labels)
    nll_r, lse_r, am_r = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    dx = xe.mlm_xent_dx(x, emb, bias, labels, lse_r, g)
    de, db = xe.mlm_xent_de(x, emb, bias, labels, lse_r, g)
    dx_r = xe.mlm_xent_dx_reference(x, emb, bias, labels, lse_r, g)
    de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, labels, lse_r, g)
    nll64, lse64 = fwd_exact(x, emb, bias, labels)
    torch.cuda.synchronize()
    assert float((nll - nll64).abs().max()) < 3e-5 and float((lse - lse64).abs().max()) < 3e-5
    clear = top2_gap(x, emb, bias) > ARGMAX_GAP
    assert torch.equal(am[clear], am_r[clear])
    assert dx.dtype == de.dtype == torch.float16 and dx.shape == x.shape and de.shape == emb.shape
    assert rel_err(dx, dx_r) < 1.2e-2 and rel_err(de, de_r) < 1.8e-2 and rel_err(db, db_r) < DB_REL_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("H", [2048, 2560])
def test_xent_wide_db_meets_the_exact_products(cuda, dtype, H):
    """The wide K6's db at the main path's rows and vocabulary within
    chip_smoke.py's DBIAS_TOL (2e-6 of its largest value) of db with the
    logits' products summed exactly (tools/xent_steps.py::db_exact, fp64),
    the yardstick the plain version's own fp32 sums drift from at these
    widths; and the kernels repeat bit for bit."""
    from visualbert_torch.tools.xent_steps import db_exact

    x, emb, bias, labels, g = form_xent_inputs(3072, 30522, H, dtype, cuda, seed=1)
    _, lse, _ = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    runs = [xe.mlm_xent_de(x, emb, bias, labels, lse, g) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert rel_err(runs[0][1], db_exact(x, emb, bias, labels, lse, g)) < 2e-6


@pytest.mark.parametrize("N,V", [(N, V) for N in (1, 200, 3071) for V in (1000, 30522)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("H", [1088, 2048, 4160, 8192])
def test_xent_wide_forward_matches_plain(cuda, H, dtype, N, V):
    """The wide K4 (128 x 128 tiles by TMA from a producer warp, two
    consumer warpgroups) at ragged rows (a warpgroup without a row at N = 1)
    and vocabulary (a last tile of 58 rows at V = 1000): nll and lse within
    XENT_TOL of the exact products' (tools/xent_steps.py::fwd_exact; the
    plain version's fp32 sums drift past it at 8192), the argmax where the
    top two logits are apart, and two calls bit for bit."""
    from visualbert_torch.tools.xent_steps import fwd_exact

    x, emb, bias, labels, _ = form_xent_inputs(N, V, H, dtype, cuda, seed=19)
    runs = [xe.mlm_xent_fwd(x, emb, bias, labels) for _ in range(2)]
    _, _, am_r = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    nll64, lse64 = fwd_exact(x, emb, bias, labels)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    nll, lse, am = runs[0]
    assert float((nll - nll64).abs().max()) < 3e-5 and float((lse - lse64).abs().max()) < 3e-5
    clear = top2_gap(x, emb, bias) > ARGMAX_GAP
    assert torch.equal(am[clear], am_r[clear])


@pytest.mark.parametrize("H", WIDE_BWD_WIDTHS)
def test_xent_f16_wide_forms_repeat_bit_for_bit(cuda, H):
    """No atomics in the fp16 wide K4-K6 either: two calls, the same bits."""
    x, emb, bias, labels, g = form_xent_inputs(3071, 30522, H, torch.float16, cuda, seed=12)
    runs = []
    for _ in range(2):
        nll, lse, am = xe.mlm_xent_fwd(x, emb, bias, labels)
        runs.append((nll, lse, am, xe.mlm_xent_dx(x, emb, bias, labels, lse, g))
                    + xe.mlm_xent_de(x, emb, bias, labels, lse, g))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype,H", [(torch.float32, 768), (torch.float32, 1088), (torch.bfloat16, 2048),
                                     (torch.float16, 2560), (torch.bfloat16, 1100), (torch.float16, 1100)], ids=str)
def test_xent_fp32_and_wide_forms_take_the_first_max(cuda, dtype, H):
    """Equal logits in one vocabulary tile (5, 9) and in two splits (5,
    V - 3), with labels of -1 (computed as 0, g = 0) among the rows: the
    lower index wins, and K5/K6 still match their plain versions."""
    N, V = 40, 30522
    x, emb, bias, labels, g = form_xent_inputs(N, V, H, dtype, cuda, seed=7)
    u = emb[5].float() * 4
    for v in (5, 9, V - 3):
        emb[v] = u.to(dtype)
        bias[v] = 0.25
    x[:] = emb[5]
    _, lse, am = xe.mlm_xent_fwd(x, emb, bias, labels)
    assert am.tolist() == [5] * N
    _, lse_r, _ = xe.mlm_xent_fwd_reference(x, emb, bias, labels)
    torch.cuda.synchronize()
    atol = F32_ABS_TOL if dtype == torch.float32 else XENT_ATOL
    assert float((lse - lse_r).abs().max()) < atol
    assert (g == 0).any() and (g > 0).any()
    dx, (de, db) = xe.mlm_xent_dx(x, emb, bias, labels, lse_r, g), xe.mlm_xent_de(x, emb, bias, labels, lse_r, g)
    de_r, db_r = xe.mlm_xent_de_reference(x, emb, bias, labels, lse_r, g)
    rel, db_rel = (F32_REL_TOL, F32_REL_TOL) if dtype == torch.float32 else (REL_TOL, DB_REL_TOL)
    assert rel_err(dx, xe.mlm_xent_dx_reference(x, emb, bias, labels, lse_r, g)) < rel
    assert rel_err(de, de_r) < rel and rel_err(db, db_r) < db_rel


# ---- K11-K14 and K7-K10 in every dtype, head dim and width ----


def variant_inputs(variant, B, T, H, D, dtype, device, seed=0):
    """(qkv, key_bias, dout) of K11/K12 ([B, 3, H, T, D], dout [B, H, T, D])
    or K13/K14 (the biased packed [B, T, H*3*D], dout [B, T, H*D])."""
    qkv, qb, key_bias, dout = form_attention_inputs(B, T, H, D, dtype, device, seed)
    if variant == "heads_major":
        qkv = qkv.view(B, T, H, 3, D).permute(0, 3, 2, 1, 4).contiguous()
        return qkv, key_bias, dout.view(B, T, H, D).permute(0, 2, 1, 3).contiguous()
    return (qkv + qb).contiguous(), key_bias, dout


def variant_run(variant, qkv, key_bias, dout, H, rate, seed, plain=False):
    """(forward outputs, dqkv) of the variant's kernels (or plain versions);
    the backward on the plain forward's outputs."""
    if variant == "heads_major":
        fwd = fa.heads_major_attention_fwd_reference if plain else fa.heads_major_attention_fwd
        bwd = fa.heads_major_attention_bwd_reference if plain else fa.heads_major_attention_bwd
        out, stats = fwd(qkv, key_bias, rate, seed)
        out_r, stats_r = fa.heads_major_attention_fwd_reference(qkv, key_bias, rate, seed)
        return (out, stats), bwd(qkv, key_bias, dout, out_r, stats_r, rate, seed)
    fwd = fa.packed_attention_sp_fwd_reference if plain else fa.packed_attention_sp_fwd
    bwd = fa.packed_attention_sp_bwd_reference if plain else fa.packed_attention_sp_bwd
    out, probs = fwd(qkv, key_bias, H, rate, seed)
    out_r, probs_r = fa.packed_attention_sp_fwd_reference(qkv, key_bias, H, rate, seed)
    return (out, probs), bwd(qkv, probs_r, dout, out_r, H, rate, seed)


VARIANTS = ["heads_major", "save_probs"]


@pytest.mark.parametrize("B,T,H", [(2, 130, 4), (4, 228, 12), (1, 1, 2)])
@pytest.mark.parametrize("D", [8, 16, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("dtype", FORM_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_attention_forms_match_plain(cuda, variant, dtype, D, B, T, H, rate):
    """K11/K12 and K13/K14 in every dtype and head dim against their plain
    versions, as K1/K2's forms: out and dqkv (fp32 within 1e-4, the rest
    within bf16's limit), K11's stats, and K13's bf16 probabilities each
    within one bf16 ulp of its plain value in every dtype; K14 fed K13's own
    probabilities and output within bf16's limit in every dtype (a
    probability one bf16 ulp from the plain one moves dqkv by more than
    fp32's bar); each launch counted in its form by attention_form (K11-K14
    run heads up to 32 on their small-row forms; bf16 at D = 48 holds the
    D = 64 kernels with a runtime scale, which the main path's fixed form
    does not reach)."""
    qkv, key_bias, dout = variant_inputs(variant, B, T, H, D, dtype, cuda)
    fwd_fn = fa.heads_major_attention_fwd if variant == "heads_major" else fa.packed_attention_sp_fwd
    bwd_fn = fa.heads_major_attention_bwd if variant == "heads_major" else fa.packed_attention_sp_bwd
    form = bwd_form = fa.attention_form(dtype, D)
    before, before_bwd = fwd_fn.forms.get(form, 0), bwd_fn.forms.get(bwd_form, 0)
    (out, second), dqkv = variant_run(variant, qkv, key_bias, dout, H, rate, 99)
    (out_r, second_r), dqkv_r = variant_run(variant, qkv, key_bias, dout, H, rate, 99, plain=True)
    torch.cuda.synchronize()
    assert fwd_fn.forms[form] == before + 1
    assert bwd_fn.forms[bwd_form] == before_bwd + 1
    assert out.dtype == dtype and out.shape == out_r.shape and dqkv.dtype == dtype and dqkv.shape == qkv.shape
    rel, st = (F32_REL_TOL, F32_ABS_TOL) if dtype == torch.float32 else (REL_TOL, STATS_ATOL)
    assert rel_err(out, out_r) < rel
    assert rel_err(dqkv, dqkv_r) < rel
    if variant == "heads_major":
        assert float((second - second_r).abs().max()) < st
    else:
        assert second.dtype == torch.bfloat16 and second.shape == (B, H, T, T)
        assert bool(((second.float() - second_r.float()).abs() <= bf16_ulps(second_r)).all())
        dqkv_own = fa.packed_attention_sp_bwd(qkv, second, dout, out, H, rate, 99)  # the kernels' own chain
        assert rel_err(dqkv_own, dqkv_r) < REL_TOL


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.bfloat16, 128), (torch.float16, 16),
                                     (torch.float32, 64), (torch.float32, 96)], ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_attention_forms_repeat_bit_for_bit(cuda, variant, dtype, D):
    qkv, key_bias, dout = variant_inputs(variant, 4, 228, 6, D, dtype, cuda)
    runs = [variant_run(variant, qkv, key_bias, dout, 6, 0.1, 7) for _ in range(2)]
    torch.cuda.synchronize()
    (f1, b1), (f2, b2) = runs
    assert all(torch.equal(a, b) for a, b in zip(f1 + (b1,), f2 + (b2,)))


@pytest.mark.parametrize("dtype,D", [(torch.float16, 64), (torch.float16, 128), (torch.float32, 64),
                                     (torch.float32, 32), (torch.bfloat16, 128), (torch.bfloat16, 16),
                                     (torch.float32, 16), (torch.float32, 30), (torch.float32, 99),
                                     (torch.float32, 100), (torch.float16, 32), (torch.bfloat16, 8)], ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_attention_forms_drop_the_plain_mask(cuda, variant, dtype, D):
    """At T = 64 keys, V and dO the identity on their first 64 columns (D >=
    64) or the rows' first D keys (D < 64, T = D): out[i, j] is the dropped
    p[i, j] and dv[j, i] the same, zero exactly where the plain mask drops."""
    B, H, rate, seed = 3, 2, 0.1, 11
    T = min(D, 64)
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(B, T, H, 3, D), dtype=dtype, device=cuda)
    x[:, :, :, 2] = torch.eye(T, D, dtype=dtype, device=cuda)[None, :, None]
    key_bias = torch.zeros((B, T), device=cuda)
    dout = torch.eye(T, D, dtype=dtype, device=cuda)[None, :, None].expand(B, T, H, D)
    if variant == "heads_major":
        qkv = x.permute(0, 3, 2, 1, 4).contiguous()
        dout = dout.permute(0, 2, 1, 3).contiguous()
        out, stats = fa.heads_major_attention_fwd(qkv, key_bias, rate, seed)
        dqkv = fa.heads_major_attention_bwd(qkv, key_bias, dout, out, stats, rate, seed)
        p_d, dv = out[..., :T], dqkv[:, 2, ..., :T].transpose(-1, -2)
    else:
        qkv = x.reshape(B, T, 3 * H * D).contiguous()
        dout = dout.reshape(B, T, H * D).contiguous()
        out, probs = fa.packed_attention_sp_fwd(qkv, key_bias, H, rate, seed)
        dqkv = fa.packed_attention_sp_bwd(qkv, probs, dout, out, H, rate, seed)
        p_d = out.view(B, T, H, D).permute(0, 2, 1, 3)[..., :T]
        dv = dqkv.view(B, T, H, 3, D)[:, :, :, 2].permute(0, 2, 3, 1)[:, :, :T]
    torch.cuda.synchronize()
    keep = fa.attention_keep_reference(seed, B, H, T, rate, cuda)
    assert torch.equal(p_d != 0, keep)
    assert torch.equal(dv != 0, keep)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_attention_at_head_dim_128_takes_t_up_to_its_shared_memory(cuda, variant, dtype):
    """At D = 128 a K/V row takes twice D = 64's shared memory: the longest
    T whose tiles fit runs, one more is refused with the limit named; fp32
    has no such limit (T = 1024 runs)."""
    lib = _build.library()
    smem = lib.vb_attn_hm_x_smem_bytes if variant == "heads_major" else lib.vb_attn_sp_x_smem_bytes
    longest = max(t for t in range(1, 1024) if smem(128, t) <= fa.MAX_SMEM_BYTES)
    assert longest >= 256
    qkv, key_bias, dout = variant_inputs(variant, 1, longest, 2, 128, dtype, cuda)
    (out, _), dqkv = variant_run(variant, qkv, key_bias, dout, 2, 0.0, 0)
    (out_r, _), dqkv_r = variant_run(variant, qkv, key_bias, dout, 2, 0.0, 0, plain=True)
    torch.cuda.synchronize()
    assert rel_err(out, out_r) < REL_TOL and rel_err(dqkv, dqkv_r) < REL_TOL
    qkv, key_bias, dout = variant_inputs(variant, 1, longest + 1, 2, 128, dtype, cuda)
    with pytest.raises(ValueError, match=f"T up to {longest}"):
        variant_run(variant, qkv, key_bias, dout, 2, 0.0, 0)
    qkv, key_bias, dout = variant_inputs(variant, 1, 1024, 1, 128, torch.float32, cuda)
    (out, _), dqkv = variant_run(variant, qkv, key_bias, dout, 1, 0.0, 0)
    (out_r, _), dqkv_r = variant_run(variant, qkv, key_bias, dout, 1, 0.0, 0, plain=True)
    torch.cuda.synchronize()
    assert rel_err(out, out_r) < F32_REL_TOL and rel_err(dqkv, dqkv_r) < F32_REL_TOL


@pytest.mark.parametrize("dtype", [torch.float64, torch.int8], ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_attention_refuses_what_no_kernel_takes(cuda, variant, dtype):
    qkv, key_bias, dout = variant_inputs(variant, 1, 8, 1, 160, torch.float16, cuda)
    with pytest.raises(ValueError, match="head dims up to 128"):
        variant_run(variant, qkv, key_bias, dout, 1, 0.0, 0)
    qkv, key_bias, dout = variant_inputs(variant, 1, 8, 1, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="bf16, fp16 or fp32"):
        variant_run(variant, qkv.to(dtype), key_bias, dout.to(dtype), 1, 0.0, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("info", ["vb_attn_hm_x_info", "vb_attn_sp_x_info"])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_variant_half_forms_at_head_dim_64_do_not_spill(cuda, info, dtype, which):
    lib = _build.library()
    code = 0 if dtype == torch.bfloat16 else 1
    regs, local, smem, per_sm = (getattr(lib, info)(code, 64, which, w, 228) for w in range(4))
    assert 0 < regs <= 255 and local == 0 and per_sm >= 1


@pytest.mark.parametrize("info", ["vb_attn_hm_info", "vb_attn_sp_info"])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_variant_main_forms_do_not_spill(cuda, info, which):
    """The bf16, D = 64 forms (the scale a constant) beside the same kernels
    with the scale an argument: the same shared memory, no spill."""
    lib = _build.library()
    main = [getattr(lib, info)(which, w, 228) for w in range(4)]
    x = [getattr(lib, info.replace("_info", "_x_info"))(0, 64, which, w, 228) for w in range(4)]
    assert 0 < main[0] <= 255 and main[1] == 0 and main[2] == x[2] and main[3] >= 1


# widths: below 8, odd, the main path's, a multiple of 8 and not of 16 up to
# 1024, above 1024 and not a multiple of 8, Megatron-BERT's, ALBERT-xxlarge's
ANY_WIDTHS = [1, 7, 63, 100, 768, 1000, 1030, 2048, 2560, 4095, 4096]


@pytest.mark.parametrize("N", [1001, 37])
@pytest.mark.parametrize("H", ANY_WIDTHS)
@pytest.mark.parametrize("dtype", list(LN_DTYPES), ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_layer_norm_forms_match_plain_at_any_width(cuda, N, H, dtype, rate):
    """K7-K10 at every width in every form against their plain versions, as
    test_layer_norm_kernels_match_plain: K9's bits [N, ceil(H / 8)] equal
    the plain packed mask (the tail bits 0) and K10 on them drops exactly
    the plain positions; each launch counted in its form."""
    x, res, dy, scale, bias = ln_inputs(N, H, cuda, dtype=dtype, seed=H)
    form = ln.layer_norm_form(dtype, H)
    before = ln.dropout_add_layer_norm_fwd.forms.get(form, 0)
    if rate == 0.0:
        fwd = ln.add_layer_norm_fwd(x, res, scale, bias)
        fwd_r = ln.add_layer_norm_fwd_reference(x, res, scale, bias)
        _, mu, rstd = fwd_r
        bwd = ln.add_layer_norm_bwd(x, res, scale, mu, rstd, dy)
        bwd_r = ln.add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy)
        torch.cuda.synchronize()
        assert_fwd_close(fwd, fwd_r)
        assert_bwd_close(bwd, bwd_r)
    fwd = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, rate, 77)
    fwd_r = ln.dropout_add_layer_norm_fwd_reference(x, res, scale, bias, rate, 77)
    _, mu, rstd, bits = fwd_r
    bwd = ln.dropout_add_layer_norm_bwd(x, res, scale, mu, rstd, dy, fwd[3], rate)
    bwd_r = ln.dropout_add_layer_norm_bwd_reference(x, res, scale, mu, rstd, dy, bits, rate)
    torch.cuda.synchronize()
    assert ln.dropout_add_layer_norm_fwd.forms[form] == before + 1
    assert fwd[3].shape == (N, -(-H // 8)) and torch.equal(fwd[3], bits)
    assert_fwd_close(fwd[:3], fwd_r[:3])
    assert_bwd_close(bwd, bwd_r)
    dropped = ~ln.unpack_bits(bits, H)
    assert not bool(bwd[0][dropped].any())
    differ = (bwd[0] == 0) != (bwd_r[0] == 0)
    largest = torch.maximum(bwd[0].float().abs(), bwd_r[0].float().abs())[differ]
    assert largest.numel() == 0 or float(largest.max()) < torch.finfo(dtype).tiny


@pytest.mark.parametrize("N,H", [(4099, 100), (37, 1030), (1001, 2048), (29184, 1030)])
def test_layer_norm_forms_repeat_bit_for_bit(cuda, N, H):
    x, res, dy, scale, bias = ln_inputs(N, H, cuda)
    runs = []
    for _ in range(2):
        y, mu, rstd, bits = ln.dropout_add_layer_norm_fwd(x, res, scale, bias, 0.1, 5)
        runs.append((y, mu, rstd, bits) + ln.dropout_add_layer_norm_bwd(x, res, scale, mu, rstd, dy, bits, 0.1)
                    + ln.add_layer_norm_bwd(x, res, scale, mu, rstd, dy))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("H", [7, 100, 1000, 1030, 2048, 4095, 4096])
@pytest.mark.parametrize("dtype", list(LN_DTYPES), ids=str)
def test_layer_norm_forms_do_not_spill(cuda, dtype, H):
    lib = _build.library()
    for kernel in (7, 8, 9, 10):
        regs, local, smem, per_sm, rows = (lib.vb_ln_info(kernel, w, H, LN_DTYPES[dtype]) for w in range(5))
        assert 0 < regs <= 255 and local == 0 and per_sm >= 1, (kernel, regs, local, per_sm)
        assert rows == (4 if H <= 1024 else 1)


def test_layer_norm_element_forms_take_unaligned_rows(cuda):
    """A width that is no multiple of 8 loads element by element: rows
    that start anywhere run; the main path's width keeps its form."""
    N, H = 37, 100
    x, res, dy, scale, bias = ln_inputs(N, H, cuda)
    flat = torch.empty(N * H + 1, dtype=torch.bfloat16, device=cuda)[1:].view(N, H)
    flat.copy_(x)
    assert flat.data_ptr() % 16 and flat.is_contiguous()
    y, mu, rstd = ln.add_layer_norm_fwd(flat, res, scale, bias)
    torch.cuda.synchronize()
    assert_fwd_close((y, mu, rstd), ln.add_layer_norm_fwd_reference(x, res, scale, bias))
    assert ln.layer_norm_form(torch.bfloat16, 768) == "bf16 warp, 16-byte"
    assert ln.layer_norm_form(torch.float32, 100) == "fp32 warp, element"
    assert ln.layer_norm_form(torch.float16, 2048) == "fp16 block, 16-byte"
    assert ln.layer_norm_form(torch.bfloat16, 1030) == "bf16 block, element"


# ---- the register-tiled fp32 kernels: the forwards of K1/K11 and K13, the backward of K2, K12 and K14 ----

F32_TILED_VARIANTS = ["packed", "heads_major", "save_probs"]


def f32_tiled_inputs(B, T, H, D, device, seed=0):
    """fp32 inputs whose key bias masks the last third of row 0's keys and,
    from T = 192 on, the whole second 64-key tile of row B - 1 (a tile of
    which every key is masked): (qkv, qb, key_bias, dout)."""
    qkv, qb, key_bias, dout = form_attention_inputs(B, T, H, D, torch.float32, device, seed)
    if T >= 192:
        key_bias[B - 1, 64:128] = -10000.0
    return qkv, qb, key_bias, dout


def f32_tiled_run(variant, qkv, qb, key_bias, dout, H, rate, seed, plain=False):
    """(forward outputs, backward outputs) of a variant's kernels (or plain
    versions), the backward on the plain forward's outputs: "packed" K1 and
    the tiled K2 (dqkv, dqb), "heads_major" K11 and the tiled K12,
    "save_probs" the tiled K13 and K14."""
    B, T, F = qkv.shape
    D = F // (3 * H)
    if variant == "packed":
        fwd = fa.packed_attention_fwd_reference if plain else fa.packed_attention_fwd
        bwd = fa.packed_attention_bwd_reference if plain else fa.packed_attention_bwd
        out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, seed)
        return fwd(qkv, qb, key_bias, H, rate, seed), bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, seed)
    x = (qkv + qb).contiguous()
    if variant == "heads_major":
        x5 = x.view(B, T, H, 3, D).permute(0, 3, 2, 1, 4).contiguous()
        d4 = dout.view(B, T, H, D).permute(0, 2, 1, 3).contiguous()
        fwd = fa.heads_major_attention_fwd_reference if plain else fa.heads_major_attention_fwd
        bwd = fa.heads_major_attention_bwd_reference if plain else fa.heads_major_attention_bwd
        out_r, stats_r = fa.heads_major_attention_fwd_reference(x5, key_bias, rate, seed)
        return fwd(x5, key_bias, rate, seed), (bwd(x5, key_bias, d4, out_r, stats_r, rate, seed),)
    fwd = fa.packed_attention_sp_fwd_reference if plain else fa.packed_attention_sp_fwd
    bwd = fa.packed_attention_sp_bwd_reference if plain else fa.packed_attention_sp_bwd
    out_r, probs_r = fa.packed_attention_sp_fwd_reference(x, key_bias, H, rate, seed)
    return fwd(x, key_bias, H, rate, seed), (bwd(x, probs_r, dout, out_r, H, rate, seed),)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 228, 1000])
@pytest.mark.parametrize("D", [16, 30, 64, 99, 100, 128])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("variant", F32_TILED_VARIANTS)
def test_f32_tiled_kernels_match_plain(cuda, variant, D, T, rate):
    """The tiled fp32 kernels against their plain versions within the fp32
    limits (chip_smoke.py's F32_REL_TOL / F32_ABS_TOL) at T on both sides of
    a 64-row tile and above the bf16 kernels' 704, head dims that are not
    multiples of 32 (100) or of 4 (30, 99: rows copied 4 bytes a piece, not
    16), a key tile wholly masked;
    K13's bf16 probabilities within one bf16 ulp, K14 on K13's own output
    within bf16's limit, and the launches counted in the fp32 form."""
    B, H = (2, 2) if T <= 228 else (1, 1)
    qkv, qb, key_bias, dout = f32_tiled_inputs(B, T, H, D, cuda)
    bwd_fn = {"packed": fa.packed_attention_bwd, "heads_major": fa.heads_major_attention_bwd,
              "save_probs": fa.packed_attention_sp_bwd}[variant]
    before = bwd_fn.forms.get("fp32", 0)
    got_f, got_b = f32_tiled_run(variant, qkv, qb, key_bias, dout, H, rate, 99)
    want_f, want_b = f32_tiled_run(variant, qkv, qb, key_bias, dout, H, rate, 99, plain=True)
    torch.cuda.synchronize()
    assert bwd_fn.forms["fp32"] == before + 1
    assert rel_err(got_f[0], want_f[0]) < F32_REL_TOL
    for g, w in zip(got_b, want_b):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert rel_err(g, w) < F32_REL_TOL
    if variant == "save_probs":
        probs, probs_r = got_f[1], want_f[1]
        assert bool(((probs.float() - probs_r.float()).abs() <= bf16_ulps(probs_r)).all())
        x = (qkv + qb).contiguous()
        assert rel_err(fa.packed_attention_sp_bwd(x, probs, dout, got_f[0], H, rate, 99), want_b[0]) < REL_TOL
    else:
        assert float((got_f[1] - want_f[1]).abs().max()) < F32_ABS_TOL


@pytest.mark.parametrize("D", [16, 30, 64, 99, 100])
@pytest.mark.parametrize("variant", F32_TILED_VARIANTS)
def test_f32_tiled_kernels_repeat_bit_for_bit(cuda, variant, D):
    """Every sum runs in a fixed order and nothing is atomic (the bias
    gradient's partials are summed in one fixed reduction): two calls agree
    bit for bit."""
    qkv, qb, key_bias, dout = f32_tiled_inputs(4, 228, 6, D, cuda)
    runs = [f32_tiled_run(variant, qkv, qb, key_bias, dout, 6, 0.1, 7) for _ in range(2)]
    torch.cuda.synchronize()
    (f1, b1), (f2, b2) = runs
    assert all(torch.equal(a, b) for a, b in zip(f1 + b1, f2 + b2))


@pytest.mark.parametrize("D", [8, 16, 32, 64, 100, 128])
@pytest.mark.parametrize("info", ["vb_attn_f32_info", "vb_attn_f32_sp_info"])
def test_f32_tiled_kernels_do_not_spill(cuda, info, D):
    """The tiled kernels (K1/K11's and K13's forwards, both backward passes in
    both forms) keep every value in registers, and at D <= 64 two blocks fit
    an SM."""
    lib = _build.library()
    for which in (0, 1, 2):
        regs, local, smem, per_sm = (getattr(lib, info)(which, w, D) for w in range(4))
        assert 0 < regs <= 255 and local == 0 and per_sm >= (2 if D <= 64 else 1), (which, regs, local, per_sm)


def test_f32_tiled_backward_tiles_64_rows(cuda):
    """The backward's blocks own 64-row tiles, one row of bias partials
    each; a head dim outside 1..128 has no kernel."""
    lib = _build.library()
    assert lib.vb_attn_f32_geometry(0) == 64 and lib.vb_attn_f32_geometry(1) == -1
    assert fa.f32_bias_tiles(lib, 228) == 4 and fa.f32_bias_tiles(lib, 64) == 1
    assert lib.vb_attn_f32_sp_info(0, 0, 129) == -1 and lib.vb_attn_f32_info(1, 0, 0) == -1


# ---- K2 at head dims 16 and 32 (bf16, fp16) on the small-row tiles; K1/K11's one-pass fp32 forward ----

SMALL_DTYPES = [torch.bfloat16, torch.float16]


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("dtype", SMALL_DTYPES, ids=str)
def test_small_row_products_match_matmul(cuda, dtype, D):
    """One m64nDk16 product with the transposed (MN-major) operand in the
    32 B / 64 B swizzle (a @ b, four k-steps) and one K-major product over
    D (q @ b^T), alone: products of bf16 or fp16 values are exact in fp32,
    so they agree with fp32 matmul up to the order of the sums."""
    rng = np.random.RandomState(D)
    a, b, q = (torch.tensor(rng.randn(*shape), dtype=dtype, device=cuda) for shape in ((64, 64), (64, D), (64, D)))
    code, ab, qb = fa.launch_small_products(_build.library(), a, b, q)
    torch.cuda.synchronize()
    assert code == 0
    want_ab, want_qb = a.float() @ b.float(), q.float() @ b.float().t()
    assert float((ab - want_ab).abs().max()) <= 1e-5 * float(want_ab.abs().max())
    assert float((qb - want_qb).abs().max()) <= 1e-5 * float(want_qb.abs().max())


def t_limit(smem, dp):
    """The largest T (a multiple of 64) whose kernels at dp fit a block's
    shared memory by ``smem`` (a ``vb_attn_*_x_smem_bytes`` query: the
    largest of a pair's three kernels, so the path's limit)."""
    return max(t for t in range(64, 8192, 64) if smem(dp, t) <= fa.MAX_SMEM_BYTES)


@pytest.mark.parametrize("T", [1, 65, 228, "limit"])
@pytest.mark.parametrize("D", [8, 16, 26, 32])
@pytest.mark.parametrize("dtype", SMALL_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_small_head_backward_matches_plain(cuda, dtype, D, T, rate):
    """K2 at head dims up to 32 runs on its "D16" / "D32" form (heads of 16
    and 32 in place, 8 and 26 zero-padded to them) against its plain version
    within bf16's limits, at T = 1, 65, 228 and the form's largest T, which
    is above the D = 64 form's 704."""
    lib = _build.library()
    dp = fa.kernel_head_dim(D)
    if T == "limit":
        T = t_limit(lib.vb_attn_packed_x_smem_bytes, dp)
        assert T > 704
    B, H = (2, 3) if T <= 228 else (1, 2)
    qkv, qb, key_bias, dout = form_attention_inputs(B, T, H, D, dtype, cuda)
    out_r, stats_r = fa.packed_attention_fwd_reference(qkv, qb, key_bias, H, rate, 99)
    form = fa.attention_form(dtype, D)
    before = fa.packed_attention_bwd.forms.get(form, 0)
    dqkv, dqb = fa.packed_attention_bwd(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
    dqkv_r, dqb_r = fa.packed_attention_bwd_reference(qkv, qb, key_bias, dout, out_r, stats_r, H, rate, 99)
    torch.cuda.synchronize()
    assert form == f"{'bf16' if dtype == torch.bfloat16 else 'fp16'} D{dp}" and dp == (16 if D <= 16 else 32)
    assert fa.packed_attention_bwd.forms[form] == before + 1
    assert dqkv.dtype == dtype and dqkv.shape == qkv.shape and dqb.shape == qb.shape
    assert rel_err(dqkv, dqkv_r) < REL_TOL
    assert rel_err(dqb, dqb_r) < REL_TOL


@pytest.mark.parametrize("dtype", SMALL_DTYPES, ids=str)
def test_small_head_backward_refuses_past_its_limit(cuda, dtype):
    lib = _build.library()
    for dp in (16, 32):
        limit = t_limit(lib.vb_attn_packed_x_smem_bytes, dp)
        qkv, qb, key_bias, dout = form_attention_inputs(1, limit + 1, 1, dp, dtype, cuda)
        stats = torch.zeros((1, 1, limit + 1), device=cuda)
        with pytest.raises(ValueError, match=f"T up to {limit}"):
            fa.packed_attention_bwd(qkv, qb, key_bias, dout, dout, stats, 1, 0.0, 0)


@pytest.mark.parametrize("dp", [16, 32])
@pytest.mark.parametrize("dtype", SMALL_DTYPES, ids=str)
def test_small_head_backward_does_not_spill(cuda, dtype, dp):
    """The forward and the dQ and dK/dV passes at dh 16 and 32 keep every
    value in registers and fit blocks an SM at the main path's T, each in
    less shared memory than at dh 64."""
    lib = _build.library()
    code = 0 if dtype == torch.bfloat16 else 1
    for which in (0, 1, 2):
        regs, local, smem, per_sm = (lib.vb_attn_packed_x_info(code, dp, which, w, 228) for w in range(4))
        assert 0 < regs <= 255 and local == 0 and per_sm >= 1, (which, regs, local, per_sm)
        assert smem < lib.vb_attn_packed_x_smem_bytes(64, 228)


# ---- K12 and K14 at head dims 16 and 32 (bf16, fp16) on the small-row tiles ----

# variant: (its backward wrapper, the shared-memory query, the info query)
SMALL_VARIANT_BWD = {"heads_major": ("heads_major_attention_bwd", "vb_attn_hm_x_smem_bytes", "vb_attn_hm_x_info"),
                     "save_probs": ("packed_attention_sp_bwd", "vb_attn_sp_x_smem_bytes", "vb_attn_sp_x_info")}


def small_variant_bwd(variant, qkv, key_bias, dout, H, rate, seed, plain=False):
    """The backward (kernel or plain) on the plain forward's outputs, the
    plain forward's (out, stats or probs), and the kernel chain's dqkv: K14
    fed K13's own probabilities and output (None for heads_major; K13 runs
    on its small-row form, whose limit is K14's)."""
    if variant == "heads_major":
        out_r, second_r = fa.heads_major_attention_fwd_reference(qkv, key_bias, rate, seed)
        bwd = fa.heads_major_attention_bwd_reference if plain else fa.heads_major_attention_bwd
        return bwd(qkv, key_bias, dout, out_r, second_r, rate, seed), (out_r, second_r), None
    out_r, second_r = fa.packed_attention_sp_fwd_reference(qkv, key_bias, H, rate, seed)
    bwd = fa.packed_attention_sp_bwd_reference if plain else fa.packed_attention_sp_bwd
    dqkv = bwd(qkv, second_r, dout, out_r, H, rate, seed)
    own = None
    if not plain:
        out, probs = fa.packed_attention_sp_fwd(qkv, key_bias, H, rate, seed)
        own = fa.packed_attention_sp_bwd(qkv, probs, dout, out, H, rate, seed)
    return dqkv, (out_r, second_r), own


@pytest.mark.parametrize("T", [1, 65, 228, "limit"])
@pytest.mark.parametrize("D", [8, 16, 26, 32])
@pytest.mark.parametrize("dtype", SMALL_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("variant", VARIANTS)
def test_small_variant_backward_matches_plain(cuda, variant, dtype, D, T, rate):
    """K12 and K14 at head dims up to 32 run on their "D16" / "D32" forms
    (heads of 16 and 32 in place, 8 and 26 zero-padded to them) against
    their plain versions within bf16's limit, at T = 1, 65, 228 and the
    form's largest T (above the D = 64 forms' 704: the backward on the
    plain forward's outputs); K14 also fed K13's own probabilities and
    output (K13 on its small-row form too, at every T); each launch counted
    in its form."""
    lib = _build.library()
    dp = fa.kernel_head_dim(D)
    if T == "limit":
        T = t_limit(getattr(lib, SMALL_VARIANT_BWD[variant][1]), dp)
        assert T > 704
    B, H = (2, 3) if T <= 228 else (1, 2)
    qkv, key_bias, dout = variant_inputs(variant, B, T, H, D, dtype, cuda)
    bwd_fn = getattr(fa, SMALL_VARIANT_BWD[variant][0])
    form = fa.attention_form(dtype, D)
    before = bwd_fn.forms.get(form, 0)
    dqkv, _, own = small_variant_bwd(variant, qkv, key_bias, dout, H, rate, 99)
    dqkv_r, _, _ = small_variant_bwd(variant, qkv, key_bias, dout, H, rate, 99, plain=True)
    torch.cuda.synchronize()
    assert form == f"{'bf16' if dtype == torch.bfloat16 else 'fp16'} D{dp}" and dp == (16 if D <= 16 else 32)
    assert bwd_fn.forms[form] == before + (1 if own is None else 2)
    assert dqkv.dtype == dtype and dqkv.shape == qkv.shape
    assert rel_err(dqkv, dqkv_r) < REL_TOL
    if variant == "save_probs":
        assert own is not None and rel_err(own, dqkv_r) < REL_TOL


@pytest.mark.parametrize("T", [1, 65, 228, "limit"])
@pytest.mark.parametrize("D", [8, 16, 26, 32])
@pytest.mark.parametrize("dtype", SMALL_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_small_save_probs_forward_matches_plain(cuda, dtype, D, T, rate):
    """K13 at head dims up to 32 runs on its "D16" / "D32" form (heads of
    16 and 32 in place, 8 and 26 zero-padded to them), counted by
    attention_form, against its plain version: out within bf16's limit,
    every bf16 probability within one bf16 ulp of its plain value, in K14's
    row layout, and K14 fed K13's own output within bf16's limit, at T = 1,
    65, 228 and the form's largest T (above the D = 64 form's 704)."""
    lib = _build.library()
    dp = fa.kernel_head_dim(D)
    if T == "limit":
        T = t_limit(getattr(lib, SMALL_VARIANT_BWD["save_probs"][1]), dp)
        assert T > 704
    B, H = (2, 3) if T <= 228 else (1, 2)
    qkv, key_bias, dout = variant_inputs("save_probs", B, T, H, D, dtype, cuda)
    form = fa.attention_form(dtype, D)
    before = fa.packed_attention_sp_fwd.forms.get(form, 0)
    out, probs = fa.packed_attention_sp_fwd(qkv, key_bias, H, rate, 99)
    out_r, probs_r = fa.packed_attention_sp_fwd_reference(qkv, key_bias, H, rate, 99)
    own = fa.packed_attention_sp_bwd(qkv, probs, dout, out, H, rate, 99)
    dqkv_r = fa.packed_attention_sp_bwd_reference(qkv, probs_r, dout, out_r, H, rate, 99)
    torch.cuda.synchronize()
    assert form == f"{'bf16' if dtype == torch.bfloat16 else 'fp16'} D{dp}"
    assert fa.packed_attention_sp_fwd.forms[form] == before + 1
    assert out.dtype == dtype and out.shape == out_r.shape and probs.shape == (B, H, T, T)
    assert probs.stride(2) == fa.probs_row_stride(T)
    assert rel_err(out, out_r) < REL_TOL
    assert bool(((probs.float() - probs_r.float()).abs() <= bf16_ulps(probs_r)).all())
    assert rel_err(own, dqkv_r) < REL_TOL


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 16), (torch.float16, 32), (torch.bfloat16, 26),
                                     (torch.float16, 8)], ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_small_variant_backward_repeats_bit_for_bit(cuda, variant, dtype, D):
    qkv, key_bias, dout = variant_inputs(variant, 4, 228, 6, D, dtype, cuda)
    runs = [small_variant_bwd(variant, qkv, key_bias, dout, 6, 0.1, 7) for _ in range(2)]
    torch.cuda.synchronize()
    (d1, _, o1), (d2, _, o2) = runs
    assert torch.equal(d1, d2)
    assert (o1 is None and o2 is None) or torch.equal(o1, o2)


@pytest.mark.parametrize("dtype", SMALL_DTYPES, ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_small_variant_backward_refuses_past_its_limit(cuda, variant, dtype):
    """One T past each small form's limit is refused with the limit named
    (K11 and K13 on their small-row forms at K12's and K14's limits)."""
    lib = _build.library()
    bwd_fn = getattr(fa, SMALL_VARIANT_BWD[variant][0])
    for dp in (16, 32):
        limit = t_limit(getattr(lib, SMALL_VARIANT_BWD[variant][1]), dp)
        T = limit + 1
        qkv, key_bias, dout = variant_inputs(variant, 1, T, 1, dp, dtype, cuda)
        with pytest.raises(ValueError, match=f"T up to {limit}"):
            if variant == "heads_major":
                bwd_fn(qkv, key_bias, dout, dout, torch.zeros((1, 1, T), device=cuda), 0.0, 0)
            else:
                bwd_fn(qkv, torch.zeros((1, 1, T, T), dtype=torch.bfloat16, device=cuda), dout, dout, 1, 0.0, 0)


@pytest.mark.parametrize("dp", [16, 32])
@pytest.mark.parametrize("dtype", SMALL_DTYPES, ids=str)
@pytest.mark.parametrize("variant", VARIANTS)
def test_small_variant_backward_does_not_spill(cuda, variant, dtype, dp):
    """K12's and K14's dQ and dK/dV passes and K11's and K13's forwards at
    dh 16 and 32 keep every value in registers and fit blocks an SM at the
    main path's T, each in less shared memory than at dh 64; the forwards'
    entry points take these head dims."""
    lib = _build.library()
    info, smem = getattr(lib, SMALL_VARIANT_BWD[variant][2]), getattr(lib, SMALL_VARIANT_BWD[variant][1])
    code = 0 if dtype == torch.bfloat16 else 1
    for which in (0, 1, 2):
        regs, local, shared, per_sm = (info(code, dp, which, w, 228) for w in range(4))
        assert 0 < regs <= 255 and local == 0 and per_sm >= 1, (which, regs, local, per_sm)
        assert shared < smem(64, 228)
    qkv, key_bias, _ = variant_inputs(variant, 1, 37, 2, dp, dtype, cuda)
    if variant == "heads_major":
        code, *_ = fa.launch_hm_x_fwd(lib, qkv, key_bias, 0.0, 0, 1, 1.0)
    else:
        code, *_ = fa.launch_sp_x_fwd(lib, qkv, key_bias, 2, 0.0, 0, 1, 1.0)
    torch.cuda.synchronize()
    assert code == 0


# ---- K1 and K11 at head dims 16 and 32 (bf16, fp16) on the small-row tiles ----

# variant: (its forward wrapper, the plain version, the shared-memory query, the info query)
SMALL_FWD = {"packed": ("packed_attention_fwd", "packed_attention_fwd_reference", "vb_attn_packed_x_smem_bytes",
                        "vb_attn_packed_x_info"),
             "heads_major": ("heads_major_attention_fwd", "heads_major_attention_fwd_reference",
                             "vb_attn_hm_x_smem_bytes", "vb_attn_hm_x_info")}


def small_fwd_run(variant, x, qb, key_bias, H, rate, seed, plain=False):
    """(out, stats) of K1 (packed: qkv and its deferred bias) or K11
    (heads_major: the biased [B, 3, H, T, D]), or of their plain versions."""
    fn = getattr(fa, SMALL_FWD[variant][1 if plain else 0])
    if variant == "packed":
        return fn(x, qb, key_bias, H, rate, seed)
    return fn(x, key_bias, rate, seed)


def small_fwd_inputs(variant, B, T, H, D, dtype, device):
    """(x, qb or None, key_bias) of K1 or K11 from form_attention_inputs."""
    qkv, qb, key_bias, _ = form_attention_inputs(B, T, H, D, dtype, device)
    if variant == "packed":
        return qkv, qb, key_bias
    return (qkv + qb).view(B, T, H, 3, D).permute(0, 3, 2, 1, 4).contiguous(), None, key_bias


@pytest.mark.parametrize("T", [37, 228, "limit"])
@pytest.mark.parametrize("D", [8, 16, 26, 32])
@pytest.mark.parametrize("dtype", SMALL_DTYPES, ids=str)
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("variant", ["packed", "heads_major"])
def test_small_forward_matches_plain(cuda, variant, dtype, D, T, rate):
    """K1 and K11 at head dims up to 32 run on their "D16" / "D32" forms
    (heads of 16 and 32 in place, 8 and 26 zero-padded to them), counted by
    attention_form, against their plain versions within bf16's limits (out,
    and the fp32 stats within 1e-4), at T = 37, 228 and the path's largest
    T (the backward's limit, past the D = 64 forms' 704); two calls give the
    same bits, and the kernel keeps every value in registers."""
    lib = _build.library()
    dp = fa.kernel_head_dim(D)
    if T == "limit":
        T = t_limit(getattr(lib, SMALL_FWD[variant][2]), dp)
        assert T > 704
    B, H = (2, 3) if T <= 228 else (1, 2)
    x, qb, key_bias = small_fwd_inputs(variant, B, T, H, D, dtype, cuda)
    fn = getattr(fa, SMALL_FWD[variant][0])
    form = fa.attention_form(dtype, D)
    before = fn.forms.get(form, 0)
    runs = [small_fwd_run(variant, x, qb, key_bias, H, rate, 99) for _ in range(2)]
    out_r, stats_r = small_fwd_run(variant, x, qb, key_bias, H, rate, 99, plain=True)
    torch.cuda.synchronize()
    (out, stats), (out2, stats2) = runs
    assert form == f"{'bf16' if dtype == torch.bfloat16 else 'fp16'} D{dp}" and dp == (16 if D <= 16 else 32)
    assert fn.forms[form] == before + 2
    assert out.dtype == dtype and out.shape == out_r.shape and stats.shape == stats_r.shape
    assert rel_err(out, out_r) < REL_TOL
    assert float((stats - stats_r).abs().max()) < STATS_ATOL
    assert torch.equal(out, out2) and torch.equal(stats, stats2)
    info = getattr(lib, SMALL_FWD[variant][3])
    code = 0 if dtype == torch.bfloat16 else 1
    regs, local, smem, per_sm = (info(code, dp, 0, w, T) for w in range(4))
    assert 0 < regs <= 255 and local == 0 and per_sm >= 1, (regs, local, per_sm)


@pytest.mark.parametrize("dtype", SMALL_DTYPES, ids=str)
@pytest.mark.parametrize("variant", ["packed", "heads_major"])
def test_small_forward_refuses_past_the_path_limit(cuda, variant, dtype):
    """One T past the path's limit at dh 16 and 32 (the backward's, which
    the forward's check takes as the largest of the three kernels') is
    refused by the forward with that limit named."""
    lib = _build.library()
    for dp in (16, 32):
        limit = t_limit(getattr(lib, SMALL_FWD[variant][2]), dp)
        x, qb, key_bias = small_fwd_inputs(variant, 1, limit + 1, 1, dp, dtype, cuda)
        with pytest.raises(ValueError, match=f"T up to {limit}"):
            small_fwd_run(variant, x, qb, key_bias, 1, 0.0, 0)


@pytest.mark.parametrize("T", [37, 228])
@pytest.mark.parametrize("D", [1, 16, 26, 64, 100, 128])
@pytest.mark.parametrize("variant", ["packed", "heads_major"])
def test_f32_one_pass_forward_matches_plain(cuda, variant, D, T):
    """K1/K11's register-tiled fp32 forward (one pass over the keys, an
    online max and sum) against the plain versions within the fp32 limits
    at ragged T, a wholly masked key tile at T = 228 and dropout 0.1, two
    calls bit for bit, and no spill at D's padded head dim."""
    B, H = 2, 3
    qkv, qb, key_bias, _ = f32_tiled_inputs(B, T, H, D, cuda)
    if variant == "packed":
        args, fwd, plain = (qkv, qb, key_bias, H), fa.packed_attention_fwd, fa.packed_attention_fwd_reference
    else:
        x5 = (qkv + qb).view(B, T, H, 3, D).permute(0, 3, 2, 1, 4).contiguous()
        args, fwd, plain = (x5, key_bias), fa.heads_major_attention_fwd, fa.heads_major_attention_fwd_reference
    runs = [fwd(*args, 0.1, 5) for _ in range(2)]
    want = plain(*args, 0.1, 5)
    torch.cuda.synchronize()
    assert rel_err(runs[0][0], want[0]) < F32_REL_TOL
    assert float((runs[0][1] - want[1]).abs().max()) < F32_ABS_TOL
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    regs, local, smem, per_sm = (_build.library().vb_attn_f32_info(0, w, D) for w in range(4))
    assert 0 < regs <= 255 and local == 0 and per_sm >= (2 if D <= 64 else 1)
