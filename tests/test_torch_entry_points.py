"""The C entry points of ``visualbert_torch/csrc/*.cu`` against the ctypes
signatures ``ops/_build.py`` binds them with, without a card.

A mismatch (an entry point renamed, an argument added on one side only, an
``int`` bound as a pointer) shows on the card only as a failed lookup or a
ctypes crash; here each ``extern "C"`` definition is parsed from the
sources the library is built from and held against ``_SIGNATURES``: the
same names, the same argument types in order, the same return type. The
Python launches are held to the same signatures with a library that
records their calls."""

import ctypes
import re

import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import flash_attention as fa

# C parameter type -> ctypes type as _build binds it
C_TYPES = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint, "float": ctypes.c_float,
           "long long": ctypes.c_longlong, "size_t": ctypes.c_size_t, "const char*": ctypes.c_char_p}
DEFINITION = re.compile(r'extern "C"\s+([\w\s\*]+?)\s*\b(vb_\w+)\s*\(([^)]*)\)\s*\{')


def c_type(decl: str):
    """The ctypes type of a C type (a parameter without its name, or a
    return type): every pointer a void pointer except ``const char*``."""
    decl = " ".join(decl.replace("*", " * ").split()).replace(" *", "*")
    if decl in C_TYPES:
        return C_TYPES[decl]
    if decl.endswith("*"):
        return ctypes.c_void_p
    raise ValueError(f"no ctypes type for {decl!r}")


def split_parameter(param: str):
    """``const void* qkv`` -> (the ctypes type of ``const void*``, "qkv")."""
    ctype, name = re.fullmatch(r"(.*?)\s*\b(\w+)", param.strip()).groups()
    return c_type(ctype), name


def definitions():
    """{name: (source, ctypes return type, [ctypes argument types],
    [parameter names])} of every ``extern "C"`` definition in the library's
    sources."""
    out = {}
    for path in _build.sources():
        if path.suffix != ".cu":
            continue
        for ret, name, params in DEFINITION.findall(path.read_text()):
            assert name not in out, f"{name} is defined in {out[name][0]} and {path.name}"
            args = [split_parameter(p) for p in params.split(",") if p.strip()]
            out[name] = (path.name, c_type(ret), [a for a, _ in args], [n for _, n in args])
    return out


DEFINED = definitions()


def test_the_sources_define_entry_points():
    assert len(DEFINED) >= 20
    assert {"vb_attn_hm_fwd", "vb_attn_hm_bwd", "vb_attn_hm_info", "vb_attn_hm_smem_bytes"} <= set(DEFINED)


@pytest.mark.parametrize("name", sorted(DEFINED))
def test_each_entry_point_is_bound_as_defined(name):
    source, ret, args, _ = DEFINED[name]
    assert name in _build._SIGNATURES, f"{name} ({source}) has no ctypes signature"
    assert _build._SIGNATURES[name] == args, f"{name} ({source}): bound {_build._SIGNATURES[name]}, defined {args}"
    assert _build.restype(name) == ret


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_each_signature_has_a_definition(name):
    assert name in DEFINED, f"_SIGNATURES binds {name}, which no source under csrc defines"


class RecordingLib:
    """Records each entry point's call and answers 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0

        return call


B, T, H, D = 2, 37, 6, 64
HG, HG_DQ, HG_DKV = 3, 2, 1


def launches():
    """Each Python launch of an attention entry point, on CPU tensors of the
    shapes the wrappers check, with head groups HG (forward) and HG_DQ,
    HG_DKV (backward): {entry point: call on a library}."""
    qkv = torch.zeros((B, T, 3 * H * D), dtype=torch.bfloat16)
    qb = torch.zeros(3 * H * D, dtype=torch.bfloat16)
    out = torch.zeros((B, T, H * D), dtype=torch.bfloat16)
    key_bias = torch.zeros((B, T))
    stats = torch.zeros((B, H, T))
    qkv5 = torch.zeros((B, 3, H, T, D), dtype=torch.bfloat16)
    out5 = torch.zeros((B, H, T, D), dtype=torch.bfloat16)
    probs = torch.zeros((B, H, T, fa.probs_row_stride(T)), dtype=torch.bfloat16)[..., :T]
    return {
        "vb_attn_packed_fwd": lambda lib: fa.launch_packed_fwd(lib, qkv, qb, key_bias, H, 0.1, 3, HG),
        "vb_attn_packed_bwd": lambda lib: fa.launch_packed_bwd(lib, qkv, qb, key_bias, out, out, stats, H, 0.1, 3,
                                                               HG_DQ, HG_DKV),
        "vb_attn_hm_fwd": lambda lib: fa.launch_hm_fwd(lib, qkv5, key_bias, 0.1, 3, HG),
        "vb_attn_hm_bwd": lambda lib: fa.launch_hm_bwd(lib, qkv5, key_bias, out5, out5, stats, 0.1, 3, HG_DQ,
                                                       HG_DKV),
        "vb_attn_sp_fwd": lambda lib: fa.launch_sp_fwd(lib, qkv, key_bias, H, 0.1, 3, HG),
        "vb_attn_sp_bwd": lambda lib: fa.launch_sp_bwd(lib, qkv, probs, probs.stride(2), out, out, H, 0.1, 3, HG_DQ,
                                                       HG_DKV),
    }


@pytest.mark.parametrize("name", sorted(launches()))
def test_each_attention_launch_passes_its_signatures_arguments(monkeypatch, name):
    """The launches hand the entry point one value per declared argument,
    an int for every pointer and integer and a float for a float, and the
    shape and head groups in the parameters of those names."""
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    lib = RecordingLib()
    launches()[name](lib)
    ((called, args),) = lib.calls
    assert called == name
    assert len(args) == len(_build._SIGNATURES[name])
    for value, argtype in zip(args, _build._SIGNATURES[name]):
        assert type(value) is (float if argtype is ctypes.c_float else int), (value, argtype)
    given = dict(zip(DEFINED[name][3], args))
    want = dict(B=B, T=T, H=H, hg=HG, hg_dq=HG_DQ, hg_dkv=HG_DKV)
    assert {k: given[k] for k in want if k in given} == {k: v for k, v in want.items() if k in given}
    assert {"B", "T", "H"} <= set(given) and ({"hg"} <= set(given) or {"hg_dq", "hg_dkv"} <= set(given))


WIDE_CLUSTERS = 30  # the wide K5/K6 clusters an H100 runs at once at width 2048


class XentLib(RecordingLib):
    """A recording library that also answers ``vb_xent_geometry`` with the
    kernels' tiling at width 768 (K4: 128 rows a block, vocabulary tiles of
    32; K5/K6: row block 64, vocabulary tile 32, all 768 columns a block),
    ``vb_xent_wide_geometry`` with the wide form's (widths in steps of 64;
    K4: 128 rows, tiles of 64; K5/K6: 64 rows, tiles of 64, at most 512
    columns a block and 16 blocks a cluster), ``vb_xent_wide_info``'s
    clusters at once (WIDE_CLUSTERS), ``vb_xent_f32_geometry`` with the
    fp32 kernels' (128 x 256 tiles) and ``vb_attn_f32_geometry`` with the
    fp32 attention backward's 64-row tiles."""

    def vb_xent_geometry(self, which, hid):
        return (hid, 128, 64, 32, 32, 768)[which]

    def vb_xent_wide_geometry(self, which):
        return (64, 128, 64, 64, 64, 512, 16)[which]

    def vb_xent_wide_info(self, kernel, what, hid):
        assert kernel in (0, 1) and what == 4
        return WIDE_CLUSTERS

    def vb_xent_f32_geometry(self, which):
        return (128, 256)[which]

    def vb_attn_f32_geometry(self, which):
        return (64,)[which]


@pytest.mark.parametrize("N,V", [(100, 1000), (3072, 30522), (1, 70)])
def test_the_xent_forward_launch_passes_its_signatures_arguments(monkeypatch, N, V):
    """K4's launch hands its entry point one int per declared argument, the
    shape in the parameters of those names, its plan's splits and tiles a
    split, and partials of the plan's shapes."""
    from visualbert_torch.ops import mlm_xent as xe

    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    H, SMS = 768, 132
    x = torch.zeros((N, H), dtype=torch.bfloat16)
    emb = torch.zeros((V, H), dtype=torch.bfloat16)
    lib = XentLib()
    code, nll, lse, am = xe.launch_fwd(lib, x, emb, torch.zeros(V), torch.zeros(N, dtype=torch.int32), SMS)
    ((called, values),) = lib.calls
    assert called == "vb_xent_fwd" and code == 0
    assert len(values) == len(_build._SIGNATURES[called])
    assert all(type(v) is int for v in values)
    given = dict(zip(DEFINED[called][3], values))
    plan = xe.fwd_plan(N, V, H, 128, 32, SMS)
    assert (given["N"], given["V"], given["hid"]) == (N, V, H)
    assert (given["S"], given["vbs"]) == (plan["grid"][1], plan["per"])
    assert nll.shape == lse.shape == am.shape == (N,)
    assert nll.dtype == lse.dtype == torch.float32 and am.dtype == torch.int32


@pytest.mark.parametrize("name", ["vb_xent_dx", "vb_xent_de"])
def test_each_xent_backward_launch_passes_its_signatures_arguments(monkeypatch, name):
    """K5/K6's launches hand their entry point one int per declared argument,
    the shape in the parameters of those names, and K5 its plan's splits and
    a partials buffer of the plan's shape."""
    from visualbert_torch.ops import mlm_xent as xe

    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    N, V, H, SMS = 100, 1000, 768, 132
    x = torch.zeros((N, H), dtype=torch.bfloat16)
    emb = torch.zeros((V, H), dtype=torch.bfloat16)
    rows = torch.zeros(N)
    args = (x, emb, torch.zeros(V), torch.zeros(N, dtype=torch.int32), rows, rows)
    lib = XentLib()
    out = xe.launch_dx(lib, *args, SMS) if name == "vb_xent_dx" else xe.launch_de(lib, *args)
    ((called, values),) = lib.calls
    assert called == name and out[0] == 0
    assert len(values) == len(_build._SIGNATURES[name])
    assert all(type(v) is int for v in values)
    given = dict(zip(DEFINED[name][3], values))
    assert (given["N"], given["V"], given["hid"]) == (N, V, H)
    if name == "vb_xent_dx":
        plan = xe.dx_plan(N, V, H, 64, 32, 768, SMS)
        assert (given["S"], given["vbs"]) == (plan["grid"][2], plan["per"])
        assert out[1].shape == (N, H) and out[1].dtype == torch.bfloat16
    else:
        assert out[1].shape == (V, H) and out[2].shape == (V,)


def form_launches():
    """The launches of the bf16/fp16 and fp32 forms of K1/K2, K11-K14 (fp16
    at head dim 64, fp32 at 48) and K4-K6 (fp16 at width 768, bf16 at 2048
    on the wide form, fp32 at 200) on CPU tensors: {entry point: (call on a
    library, the values its parameters must be given)}."""
    from visualbert_torch.ops import mlm_xent as xe

    qkv16 = torch.zeros((B, T, 3 * H * D), dtype=torch.float16)
    qb16 = torch.zeros(3 * H * D, dtype=torch.float16)
    out16 = torch.zeros((B, T, H * D), dtype=torch.float16)
    qkv32 = torch.zeros((B, T, 3 * H * 48))
    qb32 = torch.zeros(3 * H * 48)
    out32 = torch.zeros((B, T, H * 48))
    key_bias, stats = torch.zeros((B, T)), torch.zeros((B, H, T))
    qkv5_16, out5_16 = torch.zeros((B, 3, H, T, D), dtype=torch.float16), torch.zeros((B, H, T, D), dtype=torch.float16)
    qkv5_32, out5_32 = torch.zeros((B, 3, H, T, 48)), torch.zeros((B, H, T, 48))
    probs = torch.zeros((B, H, T, fa.probs_row_stride(T)), dtype=torch.bfloat16)[..., :T]
    ldp = fa.probs_row_stride(T)
    N, V = 100, 1000
    x16, e16 = torch.zeros((N, 768), dtype=torch.float16), torch.zeros((V, 768), dtype=torch.float16)
    xw, ew = torch.zeros((N, 2048), dtype=torch.bfloat16), torch.zeros((V, 2048), dtype=torch.bfloat16)
    x32, e32 = torch.zeros((N, 200)), torch.zeros((V, 200))
    f32 = xe.f32_plan(N, V, 128, 256, 132)
    wide = xe.wide_dx_plan(N, V, 2048, 64, 64, 512, WIDE_CLUSTERS)
    rows, lab = torch.zeros(N), torch.zeros(N, dtype=torch.int32)
    attn = dict(B=B, T=T, H=H)
    return {
        "vb_attn_packed_x_fwd": (lambda lib: fa.launch_packed_x_fwd(lib, qkv16, qb16, key_bias, H, 0.1, 3, HG, 0.25),
                                 dict(attn, hg=HG, dtype=1, dh=D, scale=0.25)),
        "vb_attn_packed_x_bwd": (lambda lib: fa.launch_packed_x_bwd(lib, qkv16, qb16, key_bias, out16, out16, stats,
                                                                    H, 0.1, 3, HG_DQ, HG_DKV, 0.25),
                                 dict(attn, hg_dq=HG_DQ, hg_dkv=HG_DKV, dtype=1, dh=D, scale=0.25)),
        "vb_attn_f32_fwd": (lambda lib: fa.launch_f32_fwd(lib, qkv32, qb32, key_bias, H, 0.1, 3),
                            dict(attn, D=48, scale=48 ** -0.5)),
        "vb_attn_f32_bwd": (lambda lib: fa.launch_f32_bwd(lib, qkv32, qb32, key_bias, out32, out32, stats, H, 0.1, 3),
                            dict(attn, D=48, scale=48 ** -0.5)),
        "vb_attn_hm_x_fwd": (lambda lib: fa.launch_hm_x_fwd(lib, qkv5_16, key_bias, 0.1, 3, HG, 0.25),
                             dict(attn, hg=HG, dtype=1, dh=D, scale=0.25)),
        "vb_attn_hm_x_bwd": (lambda lib: fa.launch_hm_x_bwd(lib, qkv5_16, key_bias, out5_16, out5_16, stats, 0.1, 3,
                                                            HG_DQ, HG_DKV, 0.25),
                             dict(attn, hg_dq=HG_DQ, hg_dkv=HG_DKV, dtype=1, dh=D, scale=0.25)),
        "vb_attn_sp_x_fwd": (lambda lib: fa.launch_sp_x_fwd(lib, qkv16, key_bias, H, 0.1, 3, HG, 0.25),
                             dict(attn, hg=HG, ldp=ldp, dtype=1, dh=D, scale=0.25)),
        "vb_attn_sp_x_bwd": (lambda lib: fa.launch_sp_x_bwd(lib, qkv16, probs, ldp, out16, out16, H, 0.1, 3, HG_DQ,
                                                            HG_DKV, 0.25),
                             dict(attn, hg_dq=HG_DQ, hg_dkv=HG_DKV, ldp=ldp, passes=3, dtype=1, dh=D, scale=0.25)),
        "vb_attn_f32_hm_fwd": (lambda lib: fa.launch_f32_hm_fwd(lib, qkv5_32, key_bias, 0.1, 3),
                               dict(attn, D=48, scale=48 ** -0.5)),
        "vb_attn_f32_hm_bwd": (lambda lib: fa.launch_f32_hm_bwd(lib, qkv5_32, key_bias, out5_32, out5_32, stats, 0.1,
                                                                3), dict(attn, D=48, scale=48 ** -0.5)),
        "vb_attn_f32_sp_fwd": (lambda lib: fa.launch_f32_sp_fwd(lib, qkv32, key_bias, H, 0.1, 3),
                               dict(attn, D=48, ldp=ldp, scale=48 ** -0.5)),
        "vb_attn_f32_sp_bwd": (lambda lib: fa.launch_f32_sp_bwd(lib, qkv32, probs, ldp, out32, out32, H, 0.1, 3),
                               dict(attn, D=48, ldp=ldp, scale=48 ** -0.5)),
        "vb_xent_f16_fwd": (lambda lib: xe.launch_fwd(lib, x16, e16, torch.zeros(V), lab, 132), dict(N=N, V=V, hid=768)),
        "vb_xent_f16_dx": (lambda lib: xe.launch_dx(lib, x16, e16, torch.zeros(V), lab, rows, rows, 132),
                           dict(N=N, V=V, hid=768)),
        "vb_xent_f16_de": (lambda lib: xe.launch_de(lib, x16, e16, torch.zeros(V), lab, rows, rows),
                           dict(N=N, V=V, hid=768)),
        "vb_xent_f32_fwd": (lambda lib: xe.launch_f32_fwd(lib, x32, e32, torch.zeros(V), lab, 132),
                            dict(N=N, V=V, H=200, S=f32["grid"][1], vbs=f32["per"])),
        "vb_xent_f32_dx": (lambda lib: xe.launch_f32_dx(lib, x32, e32, torch.zeros(V), lab, rows, rows, 132),
                           dict(N=N, V=V, H=200, S=f32["grid"][1], vbs=f32["per"])),
        "vb_xent_f32_de": (lambda lib: xe.launch_f32_de(lib, x32, e32, torch.zeros(V), lab, rows, rows),
                           dict(N=N, V=V, H=200)),
        "vb_xent_wide_fwd": (lambda lib: xe.launch_wide_fwd(lib, xw, ew, torch.zeros(V), lab, 132),
                             dict(N=N, V=V, hid=2048)),
        "vb_xent_wide_dx": (lambda lib: xe.launch_wide_dx(lib, xw, ew, torch.zeros(V), lab, rows, rows),
                            dict(N=N, V=V, hid=2048, S=wide["grid"][2], vbs=wide["per"])),
        "vb_xent_wide_de": (lambda lib: xe.launch_wide_de(lib, xw, ew, torch.zeros(V), lab, rows, rows),
                            dict(N=N, V=V, hid=2048)),
    }


@pytest.mark.parametrize("name", sorted(form_launches()))
def test_each_form_launch_passes_its_signatures_arguments(monkeypatch, name):
    """The launches of the other forms hand their entry point one value per
    declared argument, an int for every pointer and integer and a float for
    a float, with the shape, head groups, element type, head dim or width
    and softmax scale in the parameters of those names."""
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    launch, want = form_launches()[name]
    lib = XentLib()
    out = launch(lib)
    called, values = lib.calls[-1]
    assert called == name and out[0] == 0
    assert len(values) == len(_build._SIGNATURES[name])
    for value, argtype in zip(values, _build._SIGNATURES[name]):
        assert type(value) is (float if argtype is ctypes.c_float else int), (value, argtype)
    given = dict(zip(DEFINED[name][3], values))
    assert {k: given[k] for k in want} == pytest.approx(want)


class LnLib(RecordingLib):
    """A recording library that also answers ``vb_ln_geometry`` (rows up to
    1024 wide, 4 rows a block) and ``vb_ln_info``'s blocks an SM (PER_SM)."""

    PER_SM = 3

    def vb_ln_geometry(self, which):
        return (1024, 4, 3)[which]

    def vb_ln_info(self, kernel, what, H, dtype):
        self.calls.append(("vb_ln_info", (kernel, what, H, dtype)))
        return self.PER_SM if what == 3 else 0


LN_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


@pytest.mark.parametrize("H", [8, 200, 768, 1024])
@pytest.mark.parametrize("dtype", list(LN_DTYPES), ids=str)
@pytest.mark.parametrize("kernel", [7, 8, 9, 10])
def test_each_layer_norm_launch_passes_its_signatures_arguments(monkeypatch, kernel, dtype, H):
    """K7-K10's launches hand their entry point one value per declared
    argument (a null pointer only for K7/K8's bits and K8's dres), the shape
    and dtype code, and for K8/K10 a grid of the blocks that fit on the card
    at once (the occupancy query's answer for that kernel, width and dtype,
    times a stubbed SM count), capped at one block a 4 rows, with a
    partials buffer of that many rows; K9 returns its bits as [N, H / 8]
    uint8."""
    from visualbert_torch.ops import layer_norm as ln

    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    SMS = 132
    for N in (1, 37, 4099):
        x = torch.zeros((N, H), dtype=dtype)
        rows = torch.zeros(N)
        scale = torch.zeros(H)
        bits = torch.zeros((N, H // 8), dtype=torch.uint8)
        lib = LnLib()
        if kernel in (7, 9):
            code, y, mu, rstd, out_bits = ln.launch_fwd(lib, x, x, scale, scale, 1e-12, kernel == 9, 0.1, 5)
            name = "vb_ln_fwd"
            assert y.shape == x.shape and y.dtype == dtype and mu.shape == rstd.shape == (N,)
            assert (out_bits is None) == (kernel == 7)
            if kernel == 9:
                assert out_bits.shape == (N, H // 8) and out_bits.dtype == torch.uint8
        else:
            code, dx, dres, dscale, dbias = ln.launch_bwd(lib, x, x, scale, rows, rows, x,
                                                          bits if kernel == 10 else None, 0.1, SMS)
            name = "vb_ln_bwd"
            assert dx.shape == x.shape and (dres is None) == (kernel == 8) and dscale.shape == dbias.shape == (H,)
        assert code == 0
        launches = [(n, a) for n, a in lib.calls if n == name]
        ((_, values),) = launches
        assert len(values) == len(_build._SIGNATURES[name])
        given = dict(zip(DEFINED[name][3], values))
        nullable = {"bits"} | ({"dres"} if kernel == 8 else set())
        for pname, value, argtype in zip(DEFINED[name][3], values, _build._SIGNATURES[name]):
            if pname in nullable and value is None:
                continue
            assert type(value) is (float if argtype is ctypes.c_float else int), (pname, value, argtype)
        assert (given["N"], given["H"], given["dtype"], given["dropout"]) == (N, H, LN_DTYPES[dtype], kernel in (9, 10))
        assert (given["bits"] is None) == (kernel in (7, 8))
        if kernel in (8, 10):
            assert ("vb_ln_info", (kernel, 3, H, LN_DTYPES[dtype])) in lib.calls
            assert given["P"] == max(1, min(LnLib.PER_SM * SMS, -(-N // 4)))
            assert given["P"] == ln.bwd_blocks(N, 4, LnLib.PER_SM, SMS)


def test_layer_norm_grid_refuses_a_failed_occupancy_query():
    from visualbert_torch.ops import layer_norm as ln

    with pytest.raises(RuntimeError, match="occupancy"):
        ln.bwd_blocks(100, 4, -1, 132)
    assert ln.bwd_blocks(1, 4, 3, 132) == 1 and ln.bwd_blocks(29184, 4, 3, 132) == 396


@pytest.mark.parametrize("H", [1, 7, 100, 1030, 2048, 4096])
@pytest.mark.parametrize("kernel", [9, 10])
def test_layer_norm_launch_at_any_width_plans_rows_and_bits(monkeypatch, kernel, H):
    """At a width no multiple of 8 or above the widest row a warp owns
    (``vb_ln_geometry(0)``), K9 returns ``ceil(H / 8)`` bytes of keep bits a
    row, and K10's grid counts a warp's rows a block up to that width and
    one row a block above it."""
    from visualbert_torch.ops import layer_norm as ln

    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    SMS, N = 132, 1000  # 250 blocks of 4 rows, or 396 (3 an SM) of one
    x, rows, scale = torch.zeros((N, H), dtype=torch.bfloat16), torch.zeros(N), torch.zeros(H)
    lib = LnLib()
    if kernel == 9:
        code, _, _, _, bits = ln.launch_fwd(lib, x, x, scale, scale, 1e-12, True, 0.1, 5)
        assert code == 0 and bits.shape == (N, -(-H // 8)) == (N, ln.bits_width(H))
        return
    bits = torch.zeros((N, ln.bits_width(H)), dtype=torch.uint8)
    ln.launch_bwd(lib, x, x, scale, rows, rows, x, bits, 0.1, SMS)
    ((_, values),) = [(n, a) for n, a in lib.calls if n == "vb_ln_bwd"]
    given = dict(zip(DEFINED["vb_ln_bwd"][3], values))
    assert given["P"] == (250 if H <= 1024 else 396) and given["H"] == H


@pytest.mark.parametrize("launch,kernel", [("launch_wide_dx", 0), ("launch_wide_de", 1)])
def test_a_wide_backward_launch_raises_where_no_cluster_fits(monkeypatch, launch, kernel):
    """The wide K5/K6 run in thread-block clusters: their launches ask
    ``vb_xent_wide_info(kernel, 4, width)`` for the clusters the card runs
    at once and raise, launching nothing, where none fits."""
    from visualbert_torch.ops import mlm_xent as xe

    class NoRoom(XentLib):
        def vb_xent_wide_info(self, k, what, hid):
            assert (k, what, hid) == (kernel, 4, 2048)
            return 0

    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    N, V = 100, 1000
    xw, ew = torch.zeros((N, 2048), dtype=torch.bfloat16), torch.zeros((V, 2048), dtype=torch.bfloat16)
    rows, lab = torch.zeros(N), torch.zeros(N, dtype=torch.int32)
    lib = NoRoom()
    with pytest.raises(RuntimeError, match="no cluster"):
        getattr(xe, launch)(lib, xw, ew, torch.zeros(V), lab, rows, rows)
    assert lib.calls == []
