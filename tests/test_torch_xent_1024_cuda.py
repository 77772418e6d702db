"""K5/K6 at width 1024 on the card: the 1024 form
(``csrc/mlm_xent.cu::xent_h1024_bwd_kernel``, a thread-block cluster of two
blocks of 512 columns) in bf16 and fp16 against the plain versions, at every
ragged, single and whole row block, vocabulary tile and split of N in {3072,
37, 257, 1, 65} and V in {30522, 4099, 70}: dx and dE within chip_smoke.py's
bars (1.2e-2 / 1.8e-2 of the largest plain value), db within its DBIAS_TOL
(2e-6 of the largest plain value); the same bits on two calls; a width
zero-padded onto 1024 (1000); its registers, local bytes, shared bytes and
clusters at once; the wrapper raising, and launching nothing, on inputs it
refuses. Skips without a CUDA device (marker ``gpu``); run on the card with
``python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_xent_1024_cuda.py``.
"""

import numpy as np
import pytest
import torch

from visualbert_torch.ops import _build
from visualbert_torch.ops import mlm_xent as xe

pytestmark = pytest.mark.gpu

DX_TOL, DE_TOL, DBIAS_TOL = 1.2e-2, 1.8e-2, 2e-6  # chip_smoke.py's bars: max |kernel - plain| / max |plain|
DTYPES = (torch.bfloat16, torch.float16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel_err(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-6))


def inputs(N, V, H, dtype, device, seed=0):
    """x and embedding in ``dtype``, fp32 bias, int32 labels (15 % of them
    -1 before the clamp, g = 0 there), a non-uniform fp32 g and the plain
    lse."""
    rng = np.random.RandomState(seed)
    x = torch.tensor(rng.randn(N, H), dtype=dtype, device=device)
    emb = torch.tensor(rng.randn(V, H) * 0.05, dtype=dtype, device=device)
    bias = torch.tensor(rng.randn(V) * 0.1, dtype=torch.float32, device=device)
    labels = rng.randint(0, V, N)
    labels[rng.rand(N) < 0.15] = -1
    g = torch.tensor(np.where(labels >= 0, rng.uniform(0.5, 1.5, N), 0.0), dtype=torch.float32, device=device)
    lab = torch.tensor(np.maximum(labels, 0), dtype=torch.int32, device=device)
    _, lse, _ = xe.mlm_xent_fwd_reference(x, emb, bias, lab)
    return x, emb, bias, lab, lse, g


def check_against_plain(data):
    dx = xe.mlm_xent_dx(*data)
    de, db = xe.mlm_xent_de(*data)
    dx_r = xe.mlm_xent_dx_reference(*data)
    de_r, db_r = xe.mlm_xent_de_reference(*data)
    torch.cuda.synchronize()
    x, emb = data[:2]
    assert dx.shape == x.shape and de.shape == emb.shape and db.shape == (emb.shape[0],)
    assert dx.dtype == x.dtype and de.dtype == emb.dtype and db.dtype == torch.float32
    assert rel_err(dx, dx_r) <= DX_TOL and rel_err(de, de_r) <= DE_TOL and rel_err(db, db_r) <= DBIAS_TOL
    return dx, de, db


@pytest.mark.parametrize("V", [30522, 4099, 70])
@pytest.mark.parametrize("N", [3072, 37, 257, 1, 65])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_the_1024_form_matches_plain(cuda, dtype, N, V):
    name = "bf16" if dtype == torch.bfloat16 else "fp16"
    before = (dict(xe.mlm_xent_dx.forms), dict(xe.mlm_xent_de.forms))
    check_against_plain(inputs(N, V, 1024, dtype, cuda, seed=N + V))
    for fn, was in zip((xe.mlm_xent_dx, xe.mlm_xent_de), before):
        assert fn.forms.get(f"{name} H1024", 0) == was.get(f"{name} H1024", 0) + 1


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_the_1024_form_repeats_bit_for_bit(cuda, dtype):
    """No atomics: the clusters' order cannot change a bit of dx, dE or db."""
    data = inputs(3072, 30522, 1024, dtype, cuda, seed=4)
    first = (xe.mlm_xent_dx(*data),) + xe.mlm_xent_de(*data)
    again = (xe.mlm_xent_dx(*data),) + xe.mlm_xent_de(*data)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_a_width_padded_onto_1024_runs_on_the_1024_form(cuda, dtype):
    """Width 1000 (and every width from 769) is zero-padded to 1024 and
    runs on the same kernel; the padded columns are cut from dx and dE."""
    assert xe.kernel_width(1000) == 1024
    dx, de, _ = check_against_plain(inputs(3072, 4099, 1000, dtype, cuda, seed=8))
    assert dx.shape == (3072, 1000) and de.shape == (4099, 1000)


@pytest.mark.parametrize("dtype,info", [(torch.bfloat16, "vb_xent_info"), (torch.float16, "vb_xent_f16_info")],
                         ids=str)
@pytest.mark.parametrize("kernel", [0, 1])
def test_the_1024_form_does_not_spill_and_fits_a_cluster(cuda, kernel, dtype, info):
    lib = _build.library()
    regs, local, smem, per_sm, clusters = (getattr(lib, info)(kernel, w, 1024) for w in range(5))
    assert 0 < regs <= 255 and local == 0
    assert 0 < smem <= 232448 and per_sm == 1
    assert clusters >= 1 and clusters == xe.h1024_clusters(lib, kernel, dtype)
    assert getattr(lib, info)(kernel, 4, 768) == -1  # no cluster below 1024


@pytest.mark.parametrize("role", ["dx", "de"])
def test_the_wrapper_raises_on_what_it_refuses_and_launches_nothing(cuda, role):
    """A non-contiguous x, int64 labels or an embedding of another dtype
    raise before any launch: nothing falls back to the plain version."""
    x, emb, bias, lab, lse, g = inputs(64, 300, 1024, torch.bfloat16, cuda)
    fn = xe.mlm_xent_dx if role == "dx" else xe.mlm_xent_de
    launches = fn.launches
    bad = [(x.t().contiguous().t(), emb, bias, lab, lse, g), (x, emb, bias, lab.long(), lse, g),
           (x, emb.half(), bias, lab, lse, g)]
    for args in bad:
        with pytest.raises(ValueError):
            fn(*args)
    assert fn.launches == launches
