"""The CUDA kernels' limits, refused where a model meets its device
(``visualbert_torch/ops/limits.py::check_kernel_limits``) or where a
wrapper meets a sequence length (the heads-major and save-probs attention's
T, checked against the shared memory of each wrapper's own form), and the
head group K1/K2 take a block (``ops/flash_attention.py::head_group``).
None needs a card: ``torch.device("cuda")`` is only a name here, and the
T checks run against a stand-in for the kernel library's shared-memory
queries."""

import math

import pytest
import torch

from visualbert_torch.config import OptimizerConfig, TrainConfig, VisualBertConfig
from visualbert_torch.ops import flash_attention as fa
from visualbert_torch.ops.flash_attention import head_group
from visualbert_torch.ops.limits import check_kernel_limits
from visualbert_torch.tasks import registry
from visualbert_torch.tools import main_path
from visualbert_torch.utils.config_io import parse_task_config

CUDA = torch.device("cuda")
KERNELS_ON = dict(use_flash_attention=True, fused_mlm_xent=True, use_fused_layer_norm=True, fast_dropout=True)

# Megatron-BERT 1.3B's widths (Shoeybi et al. 2019, Table 4)
MEGATRON_1_3B = dict(hidden_size=2048, num_attention_heads=32, intermediate_size=8192)

# (config fields, the flag and the limit the message must name)
OUTSIDE = [
    (dict(use_flash_attention=True, packed_qkv=False, hidden_size=1024, num_attention_heads=4),
     "use_flash_attention", "heads-major attention kernels (K11/K12, packed_qkv false) take head dims up to 128"),
    (dict(use_flash_attention=True, flash_save_probs=True, hidden_size=1024, num_attention_heads=4),
     "flash_save_probs", "take head dims up to 128"),
    (dict(use_flash_attention=True, hidden_size=1024, num_attention_heads=4), "use_flash_attention",
     "head dims up to 128"),
    (dict(use_fused_layer_norm=True, hidden_size=4104, num_attention_heads=8), "use_fused_layer_norm", "up to 4096"),
    (dict(fast_dropout=True, dtype=torch.float64), "fast_dropout", "bf16, fp16 or fp32"),
]


@pytest.mark.parametrize("fields,flag,limit", OUTSIDE, ids=[f"{c[1]}-{c[2][-20:]}-{c[0].get('hidden_size', 768)}"
                                                          for c in OUTSIDE])
def test_a_config_outside_a_kernel_limit_is_refused_on_cuda(fields, flag, limit):
    cfg = VisualBertConfig(**fields)
    with pytest.raises(ValueError, match=flag) as exc:
        check_kernel_limits(cfg, CUDA)
    assert limit in str(exc.value)
    check_kernel_limits(cfg, "cpu")  # the plain versions take it
    check_kernel_limits(cfg, torch.device("cpu"))


# configs that were refused before the kernels took fp16, fp32, head dims
# up to 128, cross-entropy widths above 1024 (the wide form) and LayerNorm
# widths up to 4096 that are not a multiple of 8
NOW_TAKEN = [
    dict(use_flash_attention=True, dtype="float32"),
    dict(use_flash_attention=True, hidden_size=1024, num_attention_heads=8),
    dict(fused_mlm_xent=True, dtype="float32"),
    dict(fused_mlm_xent=True, hidden_size=512, num_attention_heads=8),
    dict(fused_mlm_xent=True, hidden_size=1280, num_attention_heads=20),
    dict(fused_mlm_xent=True, use_fused_layer_norm=True, **MEGATRON_1_3B),
    dict(use_flash_attention=True, packed_qkv=False, dtype="float16"),
    dict(use_flash_attention=True, flash_save_probs=True, dtype="float32"),
    dict(use_fused_layer_norm=True, hidden_size=1100, num_attention_heads=11),
    dict(use_fused_layer_norm=True, hidden_size=1284, num_attention_heads=12),
]


@pytest.mark.parametrize("fields", NOW_TAKEN, ids=["K1K2-fp32", "K1K2-head-dim-128", "K4K6-fp32", "K4K6-512",
                                                   "K4K6-1280", "K4K6-megatron", "K11K12-fp16", "K13K14-fp32",
                                                   "K7K10-1100", "K7K10-1284"])
def test_a_config_the_kernels_now_take_is_accepted_on_cuda(fields):
    check_kernel_limits(VisualBertConfig(**fields), CUDA)


@pytest.mark.parametrize("variant", [dict(packed_qkv=False), dict(flash_save_probs=True)],
                         ids=["heads-major", "save-probs"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("head_dim", [8, 16, 32, 64, 96, 128])
def test_the_variant_attention_takes_every_dtype_and_head_dim_up_to_128(variant, dtype, head_dim):
    cfg = VisualBertConfig(hidden_size=4 * head_dim, num_attention_heads=4, dtype=dtype, use_flash_attention=True,
                           **variant)
    check_kernel_limits(cfg, CUDA)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("width", [1, 7, 64, 100, 768, 1024, 1030, 2048, 2560, 4096])
def test_the_fused_layer_norm_takes_every_dtype_and_width_up_to_4096(dtype, width):
    cfg = VisualBertConfig(hidden_size=width, num_attention_heads=1, dtype=dtype, use_fused_layer_norm=True)
    check_kernel_limits(cfg, CUDA)


def test_megatron_widths_pass_with_the_unfused_cross_entropy():
    """Megatron-BERT 1.3B's widths with every kernel flag but the fused
    cross-entropy (the unfused decoder takes any width)."""
    check_kernel_limits(VisualBertConfig(**MEGATRON_1_3B, **dict(KERNELS_ON, fused_mlm_xent=False)), CUDA)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_megatron_widths_pass_with_every_kernel_flag(dtype):
    """Megatron-BERT 1.3B's widths with all four kernel flags: K4-K6 on the
    wide form (bf16, fp16) or the fp32 kernels."""
    check_kernel_limits(VisualBertConfig(**MEGATRON_1_3B, **KERNELS_ON, dtype=dtype), CUDA)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("head_dim", [8, 16, 32, 64, 96, 128])
def test_the_packed_attention_takes_every_dtype_and_head_dim_up_to_128(dtype, head_dim):
    cfg = VisualBertConfig(hidden_size=4 * head_dim, num_attention_heads=4, dtype=dtype, use_flash_attention=True)
    check_kernel_limits(cfg, CUDA)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("width", [32, 64, 128, 200, 256, 384, 512, 640, 768, 1000, 1024, 1088, 1280, 2048, 2560,
                                   4096])
def test_the_fused_cross_entropy_takes_every_dtype_and_width(dtype, width):
    cfg = VisualBertConfig(hidden_size=width, num_attention_heads=1, dtype=dtype, fused_mlm_xent=True)
    check_kernel_limits(cfg, CUDA)


@pytest.mark.parametrize("fields", [dict(), dict(hidden_size=1024, num_attention_heads=16, intermediate_size=4096)],
                         ids=["bert-base", "bert-large"])
def test_the_shipped_widths_pass(fields):
    check_kernel_limits(VisualBertConfig(**fields, **KERNELS_ON), CUDA)
    check_kernel_limits(VisualBertConfig(**fields, **KERNELS_ON, dtype="float32"), "cpu")


def test_flags_off_take_anything():
    check_kernel_limits(VisualBertConfig(hidden_size=96, num_attention_heads=3, dtype="float32"), CUDA)


def test_the_task_runner_and_the_main_path_refuse_at_build():
    """The registry's trainer and tools/main_path.build refuse before they
    build anything on the card (there is none here)."""
    block = dict(main_path.model_block(), hidden_size=1536, num_attention_heads=8, flash_save_probs=True)
    with pytest.raises(ValueError, match="head dims up to 128"):
        main_path.build(block, device="cuda")
    cfg = parse_task_config({"task": "coco_pretrain", "model": block})
    with pytest.raises(ValueError, match="use_flash_attention"):
        registry._trainer(cfg, None, "cuda")


class SmemQueries:
    """A stand-in for the kernel library's shared-memory queries of K11-K14's
    other forms: 4 * dp bytes a row of T at head dim dp (the kernels' grow
    likewise with both), each head dim asked recorded."""

    def __init__(self):
        self.asked = []

    def _bytes(self, dp, t):
        self.asked.append(dp)
        return 4 * dp * t

    vb_attn_hm_x_smem_bytes = vb_attn_sp_x_smem_bytes = _bytes


def longest_t(dp):
    return fa.MAX_SMEM_BYTES // (4 * dp)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("D,dp", [(8, 16), (16, 16), (26, 32), (32, 32)])
@pytest.mark.parametrize("variant", ["heads_major", "save_probs"])
def test_the_variant_backwards_refuse_t_at_their_own_head_dim(monkeypatch, variant, D, dp, dtype):
    """Below 33 the backwards K12 and K14 check T against their small-row
    form's shared memory (head dim 16 or 32) and name that form's limit; so
    do the forwards K11 and K13, which run on small-row forms of their own
    at the same head dim (each path is bounded by its three kernels
    together). The wrappers are made to take CPU tensors for CUDA ones; each
    refuses before it would launch."""
    lib = SmemQueries()
    monkeypatch.setattr(fa._build, "library", lambda: lib)
    monkeypatch.setattr(fa, "_on_cuda", lambda what, x: True)
    H, T = 2, longest_t(dp) + 1
    key_bias = torch.zeros((1, T))
    if variant == "heads_major":
        qkv, dout = torch.zeros((1, 3, H, T, D), dtype=dtype), torch.zeros((1, H, T, D), dtype=dtype)
        fwd = lambda: fa.heads_major_attention_fwd(qkv, key_bias, 0.0, 0)  # noqa: E731
        stats = torch.zeros((1, H, T))
        bwd = lambda: fa.heads_major_attention_bwd(qkv, key_bias, dout, dout, stats, 0.0, 0)  # noqa: E731
    else:
        qkv, dout = torch.zeros((1, T, 3 * H * D), dtype=dtype), torch.zeros((1, T, H * D), dtype=dtype)
        probs = torch.zeros((1, H, 1, 1), dtype=torch.bfloat16)
        fwd = lambda: fa.packed_attention_sp_fwd(qkv, key_bias, H, 0.0, 0)  # noqa: E731
        bwd = lambda: fa.packed_attention_sp_bwd(qkv, probs, dout, dout, H, 0.0, 0)  # noqa: E731
    with pytest.raises(ValueError, match=f"takes T up to {longest_t(dp)}$"):
        bwd()
    assert set(lib.asked) == {dp}
    lib.asked.clear()
    fwd_dp = dp
    with pytest.raises(ValueError, match=f"takes T up to {longest_t(fwd_dp)}$"):
        fwd()
    assert set(lib.asked) == {fwd_dp} and longest_t(64) < longest_t(dp)


def waves(B, H, hg, slots):
    return math.ceil(B * H // hg / slots) * hg


@pytest.mark.parametrize("per_sm", [1, 2, 3])
def test_head_group_divides_h_and_is_never_worse_than_all_heads(per_sm):
    slots = 132 * per_sm
    for B in (1, 2, 3, 5, 8, 31, 64, 96, 128, 200, 512):
        for H in (1, 2, 3, 4, 12, 16):
            hg = head_group(B, H, 132, per_sm)
            assert H % hg == 0
            assert waves(B, H, hg, slots) <= waves(B, H, H, slots)
            assert waves(B, H, hg, slots) == min(waves(B, H, d, slots) for d in range(1, H + 1) if H % d == 0)


def test_head_group_reproduces_the_hg_sweep_ordering():
    """At 264 slots (two blocks an SM on 132 SMs), B=128, H=12: hg 1, 2, 3
    and 6 tie at 6 waves-times-heads and hg 4 scores 8, so 4 is never taken
    (ties go to the fewest blocks: 6); at B=96 hg 1 scores 5 against 6."""
    assert head_group(128, 12, 132, 2) == 6
    assert head_group(96, 12, 132, 2) == 1
    assert all(head_group(B, 12, 132, 2) != 4 for B in (128, 256))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("D,dp", [(8, 16), (16, 16), (26, 32), (32, 32)])
def test_the_save_probs_forward_takes_t_up_to_its_small_form(monkeypatch, D, dp, dtype):
    """K13 at head dims up to 32 runs on its own small-row form: its check
    takes T up to that form's limit (longer than the D = 64 form's) and
    names it one past it."""
    lib = SmemQueries()
    monkeypatch.setattr(fa._build, "library", lambda: lib)
    H = 2
    for T, ok in ((longest_t(dp), True), (longest_t(dp) + 1, False)):
        qkv = torch.zeros((1, T, 3 * H * D), dtype=dtype)
        if ok:
            assert fa._check_sp("K13", qkv, torch.zeros((1, T)), H) is lib
        else:
            with pytest.raises(ValueError, match=f"takes T up to {longest_t(dp)}$"):
                fa._check_sp("K13", qkv, torch.zeros((1, T)), H)
    assert set(lib.asked) == {dp} and longest_t(dp) > longest_t(64)


class PackedQueries:
    """A stand-in for the packed kernels' shared-memory queries: K1's
    forward grows with T (4 * dp bytes a row of T), K2's two passes at head
    dim 128 (the streamed ones) hold a fixed STREAMED_BYTES whatever T, and
    at the other head dims grow as the forward does; each head dim asked
    recorded."""

    STREAMED_BYTES = 207944

    def __init__(self):
        self.asked = []

    def _bytes(self, dp, k, t):
        self.asked.append(dp)
        if k > 0 and dp == fa.STREAMED_HEAD_DIM:
            return self.STREAMED_BYTES
        return 4 * dp * t

    def vb_attn_packed_x_info(self, code, dp, k, what, t):
        assert what == 2
        return self._bytes(dp, k, t)

    def vb_attn_packed_x_smem_bytes(self, dp, t):
        return max(self._bytes(dp, k, t) for k in range(3))


class WouldLaunch(Exception):
    pass


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("D", [96, 128])
def test_k2_at_head_dim_128_refuses_no_t_and_k1_names_its_limit(monkeypatch, D, dtype):
    """At head dim 128 (96 padded to it) K2's streamed passes keep no T's
    rows in shared memory: the backward passes its checks at any T and goes
    on to its launch. K1's forward still holds a head's keys: it refuses one
    T past its limit and names it, and that limit bounds the packed path."""
    lib = PackedQueries()
    monkeypatch.setattr(fa._build, "library", lambda: lib)
    monkeypatch.setattr(fa, "_on_cuda", lambda what, x: True)

    def would_launch(*args):
        raise WouldLaunch()

    monkeypatch.setattr(fa, "packed_x_head_groups", would_launch)
    monkeypatch.setattr(fa, "launch_packed_x_bwd", would_launch)
    H, k1_limit = 2, fa.MAX_SMEM_BYTES // (4 * 128)
    for T in (k1_limit + 1, 4 * k1_limit):
        qkv, qb = torch.zeros((1, T, 3 * H * D), dtype=dtype), torch.zeros(3 * H * D, dtype=dtype)
        key_bias, dout, stats = torch.zeros((1, T)), torch.zeros((1, T, H * D), dtype=dtype), torch.zeros((1, H, T))
        with pytest.raises(WouldLaunch):
            fa.packed_attention_bwd(qkv, qb, key_bias, dout, dout, stats, H, 0.0, 0)
        with pytest.raises(ValueError, match=f"forward \\(K1\\).*takes T up to {k1_limit}$"):
            fa.packed_attention_fwd(qkv, qb, key_bias, H, 0.0, 0)
    qkv = torch.zeros((1, k1_limit, 3 * H * D), dtype=dtype)
    with pytest.raises(WouldLaunch):
        fa.packed_attention_fwd(qkv, qkv[0, 0], torch.zeros((1, k1_limit)), H, 0.0, 0)


@pytest.mark.parametrize("D,dp", [(16, 16), (26, 32), (64, 64)])
def test_k2_below_128_keeps_its_limit(monkeypatch, D, dp):
    """Below 128 K2's passes hold a head's rows as before: one T past their
    limit is refused with it named. K1's forward asks the same head dim (at
    16 and 32 its own small-row form, no longer 64) and names the same
    limit."""
    lib = PackedQueries()
    monkeypatch.setattr(fa._build, "library", lambda: lib)
    monkeypatch.setattr(fa, "_on_cuda", lambda what, x: True)
    H, T = 2, fa.MAX_SMEM_BYTES // (4 * dp) + 1
    qkv, qb = torch.zeros((1, T, 3 * H * D)), torch.zeros(3 * H * D)
    qkv, qb = qkv.to(torch.bfloat16), qb.to(torch.bfloat16)
    dout = torch.zeros((1, T, H * D), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"backward \\(K2\\).*takes T up to {T - 1}$"):
        fa.packed_attention_bwd(qkv, qb, torch.zeros((1, T)), dout, dout, torch.zeros((1, H, T)), H, 0.0, 0)
    assert set(lib.asked) == {dp}
    lib.asked.clear()
    with pytest.raises(ValueError, match=f"forward \\(K1\\).*takes T up to {T - 1}$"):
        fa.packed_attention_fwd(qkv, qb, torch.zeros((1, T)), H, 0.0, 0)
    assert set(lib.asked) == {dp}


def round_up(t, m=64):
    return -(-t // m) * m


class SourceBytes:
    """A stand-in for the shared-memory queries that computes each kernel's
    dynamic shared memory as its source does (fwd_bytes, dq_bytes,
    dkv_bytes of csrc/flash_attention_packed.cu and csrc/flash_attention.cu
    at head dims 16 and 32: a 1 KB alignment pad, 64-row tiles of 2 dp
    bytes a row, K and V rows of all Tp = T rounded up to 64 keys, fp32
    rows of Tp and, in K2's passes, the bias-gradient column sums)."""

    def _packed(self, dp, k, t):
        tp, tile = round_up(t), 64 * 2 * dp
        if k == 0:
            return 1024 + 2 * tile + 2 * tp * 2 * dp + 4 * tp
        return 1024 + 4 * tile + 2 * tp * 2 * dp + 4 * (3 * tp + (4 if k == 1 else 8) * dp)

    def _hm(self, dp, k, t):
        tp, tile = round_up(t), 64 * 2 * dp
        if k == 0:
            return 1024 + 2 * tile + 2 * tp * 2 * dp + 4 * tp
        return 1024 + 4 * tile + 2 * tp * 2 * dp + 4 * 3 * tp

    def vb_attn_packed_x_smem_bytes(self, dp, t):
        return max(self._packed(dp, k, t) for k in range(3))

    def vb_attn_packed_x_info(self, code, dp, k, what, t):
        assert what == 2
        return self._packed(dp, k, t)

    def vb_attn_hm_x_smem_bytes(self, dp, t):
        return max(self._hm(dp, k, t) for k in range(3))


# the backwards' limits at head dims 16 and 32 (K2's passes, K12's passes):
# with the forwards on their own small-row forms these bound the two paths
SMALL_PATH_LIMITS = {("packed", 16): 2880, ("packed", 32): 1472, ("heads_major", 16): 2880,
                     ("heads_major", 32): 1536}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("D,dp", [(16, 16), (26, 32), (32, 32)])
@pytest.mark.parametrize("variant", ["packed", "heads_major"])
def test_the_small_forwards_take_t_past_704_up_to_the_backwards_limit(monkeypatch, variant, D, dp, dtype):
    """At head dims up to 32 the forwards K1 and K11 hold K and V rows of 2
    dp bytes, so their own limit lies past their backward's; their checks
    take the largest of the three kernels' bytes: T past the D = 64 forms'
    704 runs up to the backward's limit (2880 / 1472 packed, 2880 / 1536
    heads-major) and one T past it is refused with that limit named."""
    lib = SourceBytes()
    monkeypatch.setattr(fa._build, "library", lambda: lib)
    monkeypatch.setattr(fa, "_on_cuda", lambda what, x: True)

    def would_launch(*args):
        raise WouldLaunch()

    monkeypatch.setattr(fa, "packed_x_head_groups", would_launch)
    monkeypatch.setattr(fa, "hm_x_head_groups", would_launch)
    limit, H = SMALL_PATH_LIMITS[(variant, dp)], 2
    fwd_alone = max(t for t in range(1, 4096) if (lib._packed if variant == "packed" else lib._hm)(dp, 0, t)
                    <= fa.MAX_SMEM_BYTES)
    assert fwd_alone > limit > 704

    def forward(T):
        key_bias = torch.zeros((1, T))
        if variant == "packed":
            qkv = torch.zeros((1, T, 3 * H * D), dtype=dtype)
            return fa.packed_attention_fwd(qkv, qkv[0, 0], key_bias, H, 0.0, 0)
        return fa.heads_major_attention_fwd(torch.zeros((1, 3, H, T, D), dtype=dtype), key_bias, 0.0, 0)

    for T in (705, limit):
        with pytest.raises(WouldLaunch):
            forward(T)
    with pytest.raises(ValueError, match=f"forward \\(K1?1\\).*takes T up to {limit}$"):
        forward(limit + 1)
