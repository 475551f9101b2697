"""The LM kernels against their plain twins on the card (K5, K7: flash
attention; K8: LayerNorm; K9: AdamW; K6: the ring hop; K10: the matmul of
the fused matmul + reduce-scatter), at small shapes, with the tolerances
of ``chip_smoke.py`` phases 5, 6 and 7.

Every test needs a CUDA device and skips without one. The module imports
neither jax nor the reference, so that it runs where only PyTorch is
installed: ``python3 -m pytest --noconftest tests/test_torch_cuda.py``
(``tests/conftest.py`` sets up jax for the rest of the suite).
"""

import pytest
import torch

from horovod_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda
BF16_EPS = 2.0 ** -7


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ck.reset_launch_counts()


def _gen():
    return torch.Generator(device="cuda").manual_seed(0)


def _rel_close(a, b, rel):
    a, b = a.double(), b.double()
    scale = torch.maximum(a.abs(), b.abs()).max()
    assert float((a - b).abs().max()) <= rel * float(scale)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_attention_matches_twin_bf16_qkv_views(d):
    """bf16 causal attention on the strided q/k/v views of a qkv tensor:
    out within one bf16 unit at its row's largest magnitude, lse to 1e-5,
    gradients to 2^-6 of each tensor's largest |value|, and two backward
    launches byte-equal."""
    gen = _gen()
    qkv = torch.randn(2, 200, 4, 3, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    do = torch.randn(2, 200, 4, d, generator=gen, device="cuda").to(
        torch.bfloat16)
    scale = d ** -0.5
    out, lse = ck.flash_attention_fwd(q, k, v, causal=True)
    out_t, lse_t = ck.flash_attention_fwd_plain(q, k, v, causal=True,
                                                scale=scale)
    row = torch.maximum(out.float().abs(), out_t.float().abs()).amax(-1)
    assert ((out.float() - out_t.float()).abs().amax(-1)
            <= BF16_EPS * row).all()
    assert ((lse - lse_t).abs() <= 1e-5 * (lse_t.abs() + 1)).all()
    dd = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = ck.flash_attention_bwd(q, k, v, do, lse, dd, causal=True)
    again = ck.flash_attention_bwd(q, k, v, do, lse, dd, causal=True)
    want = ck.flash_attention_bwd_plain(q, k, v, do, lse, dd, causal=True,
                                        scale=scale)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g.view(torch.int16), a.view(torch.int16))
        _rel_close(g, w, 2.0 ** -6)
    assert ck.launch_counts()["flash_attention_bwd"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_matches_twin_with_offsets(dtype):
    """Attention with hop offsets on both paths (f32: CUDA cores, bf16:
    tensor cores); rows that see no key give out 0 and lse 0; f32-output
    gradients to 1e-4 (f32) or 2^-6 (bf16) of each tensor's largest
    |value|."""
    gen = _gen()
    q, k, v = (torch.randn(1, t, 2, 64, generator=gen, device="cuda").to(
        dtype) for t in (96, 160, 160))
    kw = dict(causal=True, scale=0.125, q_off=0, k_off=32)
    out, lse = ck.flash_attention_fwd(q, k, v, **kw)
    out_t, lse_t = ck.flash_attention_fwd_plain(q, k, v, **kw)
    _rel_close(out, out_t, 1e-5 if dtype == torch.float32 else BF16_EPS)
    assert not out[:, :32].any() and not lse[..., :32].any()
    dd = (q.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for g, w in zip(ck.flash_attention_bwd(q, k, v, q, lse, dd,
                                           out_dtype=torch.float32, **kw),
                    ck.flash_attention_bwd_plain(q, k, v, q, lse, dd,
                                                 out_dtype=torch.float32,
                                                 **kw)):
        _rel_close(g, w, tol)


HOPPER_CASES = {  # (B, Tq, Tk, H, causal, q_off, k_off, qkv views)
    "main qkv views": (8, 1024, 1024, 16, True, 0, 0, True),
    "T=1000 ragged": (2, 1000, 1000, 2, True, 0, 0, False),
    "non-causal": (2, 512, 512, 4, False, 0, 0, False),
    "masked rows": (1, 96, 160, 2, True, 0, 32, False),
}


@pytest.mark.parametrize("case", sorted(HOPPER_CASES))
def test_hopper_attention_matches_twin(case):
    """The wgmma / TMA route (bf16, D = 64, bf16 gradients) against the
    twins with phase 5's tolerances: out within one bf16 unit of its row's
    largest magnitude, lse to 1e-5, gradients to 2^-6 of each tensor's
    largest |value|, also with D made by the dq kernel from out; rows that
    see no key give out 0 and lse 0; two backward launches byte-equal."""
    b, tq, tk, h, causal, q_off, k_off, views = HOPPER_CASES[case]
    gen = _gen()

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    if views:
        qkv = rnd(b, tq, h, 3, 64)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    else:
        q, k, v = rnd(b, tq, h, 64), rnd(b, tk, h, 64), rnd(b, tk, h, 64)
    do = rnd(b, tq, h, 64)
    assert ck._hopper_route(q)
    kw = dict(causal=causal, scale=0.125, q_off=q_off, k_off=k_off)
    out, lse = ck.flash_attention_fwd(q, k, v, **kw)
    out_t, lse_t = ck.flash_attention_fwd_plain(q, k, v, **kw)
    row = torch.maximum(out.float().abs(), out_t.float().abs()).amax(-1)
    assert ((out.float() - out_t.float()).abs().amax(-1)
            <= BF16_EPS * row).all()
    assert ((lse - lse_t).abs() <= 1e-5 * (lse_t.abs() + 1)).all()
    hidden = max(0, k_off - q_off)  # rows that see no key
    assert not out[:, :hidden].any() and not lse[..., :hidden].any()
    dd = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    got = ck.flash_attention_bwd(q, k, v, do, lse, dd, **kw)
    again = ck.flash_attention_bwd(q, k, v, do, lse, dd, **kw)
    want = ck.flash_attention_bwd_plain(q, k, v, do, lse, dd, **kw)
    made = ck.flash_attention_bwd(q, k, v, do, lse, out=out, **kw)
    made2 = ck.flash_attention_bwd(q, k, v, do, lse, out=out, **kw)
    for g, a, m, m2, w in zip(got, again, made, made2, want):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g.view(torch.int16), a.view(torch.int16))
        assert torch.equal(m.view(torch.int16), m2.view(torch.int16))
        _rel_close(g, w, 2.0 ** -6)
        _rel_close(m, w, 2.0 ** -6)  # D made by the dq kernel from out
    assert ck.launch_counts()["flash_attention_fwd"] == 1
    assert ck.launch_counts()["flash_attention_bwd"] == 4


def test_hopper_attention_launches_from_a_fresh_thread():
    """A thread that has made no CUDA runtime call has no current context,
    which encoding a tensor map needs (the autograd thread can reach the
    launchers first): the kernels still launch there and give the same
    bytes as on the main thread."""
    import threading

    gen = _gen()
    q, k, v, do = (torch.randn(2, 256, 2, 64, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    want_out, lse = ck.flash_attention_fwd(q, k, v, causal=True)
    want = ck.flash_attention_bwd(q, k, v, do, lse, out=want_out,
                                  causal=True)
    # freed blocks of every size the thread asks for: its allocations then
    # make no runtime call that would bind a context for it
    spare = [ck.flash_attention_fwd(q, k, v, causal=True),
             ck.flash_attention_bwd(q, k, v, do, lse, out=want_out,
                                    causal=True)]
    torch.cuda.synchronize()
    del spare
    got = {}

    def run():
        try:
            out, _ = ck.flash_attention_fwd(q, k, v, causal=True)
            got["out"] = out
            got["grads"] = ck.flash_attention_bwd(q, k, v, do, lse, out=out,
                                                  causal=True)
        except Exception as e:  # reported by the main thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    torch.cuda.synchronize()
    assert torch.equal(got["out"].view(torch.int16),
                       want_out.view(torch.int16))
    for g, w in zip(got["grads"], want):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))


def test_layer_norm_and_adamw_match_twins():
    """K8 to one bf16 unit (plus 1e-6 of the row's largest |y|), mean and
    rstd to 2e-6 / 4e-6; K9 bit for bit, one launch over two leaves."""
    gen = _gen()
    x = torch.randn(512, 1000, generator=gen, device="cuda").to(
        torch.bfloat16)
    g, b = (torch.randn(1000, generator=gen, device="cuda") for _ in "gb")
    y, mean, rstd = ck.layer_norm_fwd(x, g, b)
    yt, mean_t, rstd_t = ck.layer_norm_fwd_plain(x, g, b, 1e-6)
    yd, ytd = y.double(), yt.double()
    bound = (BF16_EPS * torch.maximum(yd.abs(), ytd.abs())
             + 1e-6 * ytd.abs().amax(1, keepdim=True))
    assert ((yd - ytd).abs() <= bound).all()
    assert ((mean - mean_t).abs()
            <= 2e-6 * x.float().abs().amax(1)).all()
    assert ((rstd - rstd_t).abs() <= 4e-6 * rstd_t).all()
    ps = [torch.randn(n, generator=gen, device="cuda") for n in (4097, 3)]
    gs = [torch.randn_like(p) for p in ps]
    mus = [torch.zeros_like(p, dtype=torch.bfloat16) for p in ps]
    nus = [torch.zeros_like(p) for p in ps]
    twin = [[t.clone() for t in ts] for ts in (ps, mus, nus)]
    sc = dict(lr=0.01, ibc1=10.0, ibc2=1000.0, b1=0.9, b2=0.999, eps=1e-8)
    ck.adamw_update(ps, gs, mus, nus, weight_decay=0.01, **sc)
    for p, gg, mu, nu in zip(twin[0], gs, twin[1], twin[2]):
        ck.adamw_update_plain(p, gg, mu, nu, wd=0.01, **sc)
    for got, want in zip((ps, mus, nus), twin):
        for a, c in zip(got, want):
            assert torch.equal(a, c)
    assert ck.launch_counts()["adamw_update"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_step_matches_twin_on_three_hops(dtype):
    """K6 on rank 1 of a 3-rank causal ring, the carry chained: the
    diagonal hop, the hop below it and the fully masked hop above it, which
    leaves the carry bit for bit; m to 1e-5 (1 + |m|), l to 1e-5 of its
    value (both sum the unrounded p), o to 1e-5 (f32) or 2^-7 (bf16: p
    rounds to bf16 against another running maximum) of its largest
    |value|."""
    gen = _gen()
    t, h, d = 96, 2, 64
    q, k, v = (torch.randn(1, 3 * t, h, d, generator=gen, device="cuda").to(
        dtype) for _ in range(3))
    rel = 1e-5 if dtype == torch.float32 else BF16_EPS
    carry = [torch.full((1, h, t), float("-inf"), device="cuda"),
             torch.zeros(1, h, t, device="cuda"),
             torch.zeros(1, t, h, d, device="cuda")]
    twin = [c.clone() for c in carry]
    qb = q[:, t:2 * t]
    for src in (1, 0, 2):
        kb, vb = k[:, src * t:(src + 1) * t], v[:, src * t:(src + 1) * t]
        kw = dict(causal=True, scale=0.125, q_off=t, k_off=src * t)
        before = [c.clone() for c in carry]
        ck.flash_attention_step(qb, kb, vb, *carry, **kw)
        twin = list(ck.flash_attention_step_plain(qb, kb, vb, *twin, **kw))
        torch.cuda.synchronize()
        if src == 2:
            assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(carry, before))
        m, l, o = carry
        assert ((m - twin[0]).abs() <= 1e-5 * (1 + twin[0].abs())).all()
        assert ((l - twin[1]).abs() <= 1e-5 * twin[1]).all()
        _rel_close(o, twin[2], rel)
    assert ck.launch_counts()["flash_attention_step"] == 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hop_backward_above_the_diagonal_gives_exact_zeros(dtype):
    """K7 with f32 outputs where every key lies past the last q row
    (k_off > q_off + Tq - 1, far past it too): dq, dk and dv are exact
    zeros, as the ring's backward needs on the hops above the diagonal."""
    gen = _gen()
    q, k, v, do = (torch.randn(1, 200, 2, 64, generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    lse = torch.randn(1, 2, 200, generator=gen, device="cuda")
    dd = torch.randn(1, 2, 200, generator=gen, device="cuda")
    for k_off in (200, 4096):
        for g in ck.flash_attention_bwd(q, k, v, do, lse, dd, causal=True,
                                        out_dtype=torch.float32, q_off=0,
                                        k_off=k_off):
            torch.cuda.synchronize()
            assert g.dtype == torch.float32 and not g.any()


@pytest.mark.parametrize("dtype,shape", [(torch.bfloat16, (520, 384, 640)),
                                         (torch.float32, (264, 512, 384))])
def test_matmul_matches_twin_and_counts_launches(dtype, shape):
    """K10 against ``torch.matmul`` of the f32 operands (TF32 off): within
    2 K 2^-24 (|x| @ |w|) plus one unit in the last place of the output,
    two launches byte-equal, one launch counted each."""
    m, k, n = shape
    gen = _gen()
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = torch.randn(k, n, generator=gen, device="cuda").to(dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = ck.matmul_2d_plain(x, w)
        mag = x.float().abs() @ w.float().abs()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    got = ck.matmul_2d(x, w)
    again = ck.matmul_2d(x, w)
    assert ck.launch_counts()["matmul_2d"] == 2
    assert got.dtype == dtype and torch.equal(got, again)
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}[dtype]
    bound = (2 * k * 2.0 ** -24 * mag
             + ulp * torch.maximum(got.float().abs(), want.float().abs()))
    assert ((got.float() - want.float()).abs() <= bound).all()
