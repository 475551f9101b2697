"""The kernels against their plain twins on the card (K5, K7: flash
attention; K8: LayerNorm; K9: AdamW; K6: the ring hop; K10: the matmul of
the fused matmul + reduce-scatter; the int8 wire quantizers #1, its
many-leaf launch, and #3; K4, the Adasum combine, alone and grouped), at
small shapes and at the shapes where their paths part, with the
tolerances of ``chip_smoke.py`` phases 1, 1b, 5, 6 and 7 (the quantizers
bit for bit); K9 from device scalars against its host-scalar bits; and
the compiled step (``spmd.make_train_step``) as a CUDA graph against the
eager step over 3 steps with a changing lr, a small LM (K5, K7, K8, K9)
and a small ResNet (#1, #2), with its launches per replay.

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
    assert ck._hopper_route(q.dtype, q.shape[3])
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


def _carry(gen, b, t, h, d):
    """The carry of an earlier hop: finite m, positive l, o of either
    sign."""
    return [torch.randn(b, h, t, generator=gen, device="cuda"),
            torch.rand(b, h, t, generator=gen, device="cuda") * 8 + 1,
            torch.randn(b, t, h, d, generator=gen, device="cuda")]


def _step_close(carry, twin, rel):
    """K6's carry against the twin's with phase 6's tolerances: m infinite
    in the same places and else to 1e-5 (1 + |m|), l to 1e-5 of its value,
    o to ``rel`` of its largest |value|."""
    (m, l, o), (mt, lt, ot) = carry, twin
    assert torch.equal(torch.isinf(m), torch.isinf(mt))
    fin = torch.isfinite(mt)
    assert ((m - mt).abs()[fin] <= 1e-5 * (1 + mt.abs()[fin])).all()
    assert ((l - lt).abs() <= 1e-5 * lt).all()
    _rel_close(o, ot, rel)


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
        _step_close(carry, twin, rel)
    assert ck.launch_counts()["flash_attention_step"] == 3


def test_ring_step_keeps_the_carry_of_hidden_rows_bit_for_bit():
    """K6 (bf16, the wgmma route) at a ragged T = 1000 with k_off = 192:
    the first block's rows see no key (it returns at once), and the second
    block's first warpgroup (rows 128..191) sees none while its second
    does. The carry of rows 0..191 stays bit for bit; the rest matches the
    twin."""
    gen = _gen()
    b, t, h, d = 2, 1000, 2, 64
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    carry = _carry(gen, b, t, h, d)
    before = [c.clone() for c in carry]
    kw = dict(causal=True, scale=0.125, q_off=0, k_off=192)
    ck.flash_attention_step(q, k, v, *carry, **kw)
    twin = ck.flash_attention_step_plain(q, k, v, *before, **kw)
    torch.cuda.synchronize()
    m, l, o = carry
    for got, was in ((m[..., :192], before[0][..., :192]),
                     (l[..., :192], before[1][..., :192]),
                     (o[:, :192], before[2][:, :192])):
        assert torch.equal(got.view(torch.int32), was.view(torch.int32))
    _step_close(carry, twin, BF16_EPS)
    assert ck.launch_counts()["flash_attention_step"] == 1


def test_ring_step_streams_long_keys_at_one_head():
    """K6 (bf16) with Tq = 4096 against Tk = 16384 at B = H = 1, the last
    rank's hop of a 16384-token sequence in one step, from an empty carry:
    the carry matches the twin."""
    gen = _gen()
    q = torch.randn(1, 4096, 1, 64, generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn(1, 16384, 1, 64, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    carry = [torch.full((1, 1, 4096), float("-inf"), device="cuda"),
             torch.zeros(1, 1, 4096, device="cuda"),
             torch.zeros(1, 4096, 1, 64, device="cuda")]
    kw = dict(causal=True, scale=0.125, q_off=12288, k_off=0)
    twin = ck.flash_attention_step_plain(q, k, v, *carry, **kw)
    ck.flash_attention_step(q, k, v, *carry, **kw)
    torch.cuda.synchronize()
    _step_close(carry, twin, BF16_EPS)


@pytest.mark.parametrize("src", [0, 1], ids=["below", "diagonal"])
def test_hop_backward_f32_matches_twin_and_repeats_bytes(src):
    """K7 with f32 gradients (bf16 operands, the wgmma route) on rank 1 of
    a 2-rank causal ring of 2 x 200 rows, at the hop below the diagonal
    and on it, with the global lse and D: each gradient within 2^-6 of its
    largest |value| of the twin's, and two launches byte-equal."""
    gen = _gen()
    t, h = 200, 2
    q, k, v, do = (torch.randn(1, 2 * t, h, 64, generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    qb, dob = q[:, t:], do[:, t:]
    out, lse = ck.flash_attention_fwd(qb, k, v, causal=True, scale=0.125,
                                      q_off=t, k_off=0)
    dd = (dob.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    kb, vb = k[:, src * t:(src + 1) * t], v[:, src * t:(src + 1) * t]
    kw = dict(causal=True, scale=0.125, q_off=t, k_off=src * t,
              out_dtype=torch.float32)
    got = ck.flash_attention_bwd(qb, kb, vb, dob, lse, dd, **kw)
    again = ck.flash_attention_bwd(qb, kb, vb, dob, lse, dd, **kw)
    want = ck.flash_attention_bwd_plain(qb, kb, vb, dob, lse, dd, **kw)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.float32
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        _rel_close(g, w, 2.0 ** -6)
    assert ck.launch_counts()["flash_attention_bwd"] == 2


def test_ring_step_launches_from_a_fresh_thread():
    """K6's launcher encodes tensor maps, which needs a current context: a
    thread that has made no CUDA runtime call still launches it (in place,
    so it allocates nothing) and gets the main thread's bytes."""
    import threading

    gen = _gen()
    q, k, v = (torch.randn(1, 256, 2, 64, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    start = _carry(gen, 1, 256, 2, 64)
    kw = dict(causal=True, scale=0.125, q_off=256, k_off=0)
    want = [c.clone() for c in start]
    ck.flash_attention_step(q, k, v, *want, **kw)
    got = [c.clone() for c in start]
    torch.cuda.synchronize()
    error = []

    def run():
        try:
            ck.flash_attention_step(q, k, v, *got, **kw)
        except Exception as e:  # reported by the main thread
            error.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert not error, error
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


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


def _mm_bound(x, w, got, want):
    """K10's bound against its twin (chip_smoke.py phase 7): 2 K 2^-24
    (|x| @ |w|) plus one unit in the last place of the output."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mag = x.float().abs() @ w.float().abs()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}[x.dtype]
    return (2 * x.shape[1] * 2.0 ** -24 * mag
            + ulp * torch.maximum(got.float().abs(), want.float().abs()))


def _mm_twin(x, w):
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return ck.matmul_2d_plain(x, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


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
    want = _mm_twin(x, w)
    got = ck.matmul_2d(x, w)
    again = ck.matmul_2d(x, w)
    assert ck.launch_counts()["matmul_2d"] == 2
    assert got.dtype == dtype and torch.equal(got, again)
    assert ((got.float() - want.float()).abs()
            <= _mm_bound(x, w, got, want)).all()


MM_CASES = {  # (M, K, N) on each of K10's two schedules, ragged M on each
    "lm_head chunk (resident B)": (2048, 256, 32768),
    "M=520, resident B": (520, 256, 32768),
    "M=8, resident B, K=128": (8, 128, 32768),
    "M=520, K=256, streaming (too few columns for resident B)": (
        520, 256, 16384),
    "M=520, K=1024, streaming": (520, 1024, 1024),
    "M=8, streaming": (8, 128, 256),
}


@pytest.mark.parametrize("case", sorted(MM_CASES))
def test_matmul_wgmma_matches_twin(case):
    """The bf16 wgmma / TMA kernels at the LM-head chunk and at ragged M on
    each schedule (B resident for all of K, or A and B streamed): within
    phase 7's bound of the twin, two launches byte-equal, nothing written
    past row M (the TMA store clips the last tile)."""
    m, k, n = MM_CASES[case]
    gen = _gen()
    x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn(k, n, generator=gen, device="cuda").to(torch.bfloat16)
    want = _mm_twin(x, w)
    got = ck.matmul_2d(x, w)
    again = ck.matmul_2d(x, w)
    # the launcher itself, into the first m rows of a larger buffer: the
    # rows after them must keep their value
    buf = torch.full((m + 64, n), 7.0, device="cuda", dtype=torch.bfloat16)
    ck._launch("hvd_matmul", x.get_device(), x.data_ptr(), w.data_ptr(), 1,
               m, k, n, buf.data_ptr())
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    assert torch.equal(buf[:m].view(torch.int16), got.view(torch.int16))
    assert bool((buf[m:] == 7.0).all())
    assert ((got.float() - want.float()).abs()
            <= _mm_bound(x, w, got, want)).all()
    assert ck.launch_counts()["matmul_2d"] == 2


def test_matmul_launches_from_a_fresh_thread():
    """K10's launcher encodes tensor maps, which needs a current context: a
    thread that has made no CUDA runtime call still launches it and gets
    the main thread's bytes."""
    import threading

    gen = _gen()
    x = torch.randn(256, 256, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randn(256, 512, generator=gen, device="cuda").to(
        torch.bfloat16)
    want = ck.matmul_2d(x, w)
    spare = ck.matmul_2d(x, w)  # a freed block of the output's size
    torch.cuda.synchronize()
    del spare
    got = {}

    def run():
        try:
            got["out"] = ck.matmul_2d(x, w)
        except Exception as e:  # reported by the main thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    torch.cuda.synchronize()
    assert torch.equal(got["out"].view(torch.int16), want.view(torch.int16))


LN_EPS = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
          torch.float32: 2.0 ** -23}


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (4096, 1024)),   # the register pass, 4 chunks a lane
    (torch.bfloat16, (64, 2048)),     # 8 chunks, gamma / beta from smem
    (torch.float16, (100, 1280)),     # 5 chunks, the 6-chunk variant
    (torch.float32, (300, 1001)),     # the general loop, one element a lane
    (torch.bfloat16, (256, 4096)),    # the general loop, 16-byte accesses
    (torch.float32, (300, 1024)),     # the register pass, 8 f32 chunks
    (torch.bfloat16, (64, 512)),      # the register pass, 2 chunks
])
def test_layer_norm_paths_match_twin(dtype, shape):
    """K8 on the register pass and on the general loop: y within one unit
    in the last place (plus 1e-6 of the row's largest |y|), mean to 2e-6
    of the row's largest |x|, rstd to 4e-6 relative, two launches
    byte-equal."""
    n, d = shape
    gen = _gen()
    x = (torch.randn(n, d, generator=gen, device="cuda") * 3
         + torch.rand(n, 1, generator=gen, device="cuda")).to(dtype)
    g, b = (torch.randn(d, generator=gen, device="cuda") for _ in "gb")
    y, mean, rstd = ck.layer_norm_fwd(x, g, b, 1e-6)
    y2, mean2, rstd2 = ck.layer_norm_fwd(x, g, b, 1e-6)
    yt, mean_t, rstd_t = ck.layer_norm_fwd_plain(x, g, b, 1e-6)
    torch.cuda.synchronize()
    assert ck.launch_counts()["layer_norm_fwd"] == 2
    assert y.dtype == dtype
    bits = {2: torch.int16, 4: torch.int32}[y.element_size()]
    assert torch.equal(y.view(bits), y2.view(bits))
    assert torch.equal(mean, mean2) and torch.equal(rstd, rstd2)
    yd, ytd = y.double(), yt.double()
    bound = (LN_EPS[dtype] * torch.maximum(yd.abs(), ytd.abs())
             + 1e-6 * ytd.abs().amax(1, keepdim=True))
    assert ((yd - ytd).abs() <= bound).all()
    assert ((mean - mean_t).abs() <= 2e-6 * x.float().abs().amax(1)).all()
    assert ((rstd - rstd_t).abs() <= 4e-6 * rstd_t).all()


def _wire_rows(gen, rows, block, dtype):
    """Rows with magnitudes spread over six decades, an all-zero row and a
    row of exact .5 ties (its absmax 127 makes the scale 1)."""
    x = torch.randn(rows, block, generator=gen, device="cuda") * torch.pow(
        10.0, torch.rand(rows, 1, generator=gen, device="cuda") * 6 - 4)
    x[0] = 0
    if rows > 1:
        x[1] = 0
        x[1, :8] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                 -127.0])
    return x.to(dtype)


def _same_bits(a, b):
    if a.is_floating_point():
        bits = {4: torch.int32, 2: torch.int16}[a.element_size()]
        a, b = a.view(bits), b.view(bits)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("dtype,shape", [
    # the register path at 1056 tiles or more (132 SMs x 8 blocks)
    (torch.float32, (33792, 256)),   # whole tiles of 32 rows only
    (torch.float32, (33793, 256)),   # a ragged last tile of 1 row
    (torch.float32, (33795, 256)),   # rows not a multiple of 4 (or a tile)
    (torch.bfloat16, (67600, 128)),  # 8 lanes a row, tiles of 64
    (torch.float16, (16900, 512)),   # a warp a row, tiles of 16
    (torch.float32, (1000, 256)),    # too few tiles: the general loop
    (torch.float32, (50, 100)),      # ragged B: the general loop, scalar
    (torch.bfloat16, (40, 1024)),    # the general loop, 16-byte loads
])
def test_int8_quantizers_match_twin_bit_for_bit(dtype, shape):
    """#1 (q and scales) and #3 (packed rows, scale bytes included) equal
    their twins byte for byte on the register path (taken when the tiles,
    32 rows of 256, 64 of 128 or 16 of 512, fill every block that fits on
    the card), at ragged row counts and on the general loop; one launch
    each."""
    x = _wire_rows(_gen(), *shape, dtype)
    q, s = ck.int8_quantize_2d(x)
    p = ck.int8_quantize_pack_2d(x)
    qt, st = ck.int8_quantize_2d_plain(x)
    torch.cuda.synchronize()
    assert _same_bits(q, qt) and _same_bits(s, st)
    assert _same_bits(p, ck.int8_quantize_pack_2d_plain(x))
    counts = ck.launch_counts()
    assert counts["int8_quantize_2d"] == counts["int8_quantize_pack_2d"] == 1


def _edge_leaves(gen):
    """Leaves of a step's kinds: a large one (so that the f32 leaves fill
    the card with tiles at block 256 and take the register path), whole
    blocks, a ragged tail, one short block, an all-zero leaf, a leaf with
    a NaN, and between them a bf16 group (rows of the f32 launch that it
    does not own) whose last leaf starts 4 bytes into its storage (so that
    group takes the general loop)."""
    def f32(n):
        return torch.randn(n, generator=gen, device="cuda")

    def bf16(n):
        return f32(n).to(torch.bfloat16)

    nan = f32(600)
    nan[517] = float("nan")
    return [f32(256 * 34000), f32(256 * 9), bf16(513), f32(1000), f32(7),
            bf16(256), f32(64 * 3 * 3), torch.zeros(300, device="cuda"), nan,
            bf16(1026)[2:]]


@pytest.mark.parametrize("block", [256, 100])
def test_int8_quantize_many_matches_twin_and_per_leaf(block):
    """The grouped #1 over leaves of two dtypes: every scale bit for bit
    against the twin and every q byte of the rows without a NaN (the twin's
    int8 of NaN is undefined); every byte against #1 on each leaf padded
    by hand; one launch per dtype."""
    import torch.nn.functional as F

    leaves = _edge_leaves(_gen())
    q, s = ck.int8_quantize_2d_many(leaves, block)
    assert ck.launch_counts()["int8_quantize_2d"] == 2
    qt, st = ck.int8_quantize_2d_many_plain(leaves, block)
    torch.cuda.synchronize()
    assert _same_bits(s, st)
    keep = ~torch.isnan(st[:, 0])
    assert not keep.all() and torch.equal(q[keep], qt[keep])
    row = 0
    for t in leaves:
        n = t.numel()
        rows = -(-n // block)
        qi, si = ck.int8_quantize_2d(
            F.pad(t, (0, rows * block - n)).reshape(rows, block))
        assert _same_bits(q[row:row + rows], qi)
        assert _same_bits(s[row:row + rows], si)
        row += rows
    assert row == q.shape[0]


def test_int8_quantize_many_takes_a_launch_per_table():
    """More leaves than one table holds take one launch per table-full,
    and equal the twin. Each table holds enough rows for the register
    path, and the later ones start at rows that are not a multiple of 4
    (their scale columns are not 16-byte aligned)."""
    per_table = ck._kernel("hvd_int8_table_leaves")[1]()
    gen = _gen()
    leaves = [torch.randn(256 * 201 + 1 + (37 * i) % 700, generator=gen,
                          device="cuda")
              for i in range(2 * per_table + 5)]
    q, s = ck.int8_quantize_2d_many(leaves, 256)
    qt, st = ck.int8_quantize_2d_many_plain(leaves, 256)
    torch.cuda.synchronize()
    assert ck.launch_counts()["int8_quantize_2d"] == 3
    assert _same_bits(q, qt) and _same_bits(s, st)


def test_int8_quantizers_launch_from_a_fresh_thread():
    """#1, the grouped #1 and #3 launched from a thread that has made no
    CUDA runtime call give the main thread's bytes."""
    import threading

    gen = _gen()
    x = _wire_rows(gen, 33795, 256, torch.float32)
    leaves = _edge_leaves(gen)

    def calls():
        return (*ck.int8_quantize_2d(x), ck.int8_quantize_pack_2d(x),
                *ck.int8_quantize_2d_many(leaves, 256))

    want = calls()
    spare = calls()  # freed blocks of every size the thread asks for
    torch.cuda.synchronize()
    del spare
    got = {}

    def run():
        try:
            got["out"] = calls()
        except Exception as e:  # reported by the main thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    torch.cuda.synchronize()
    for g, w in zip(got["out"], want):
        assert _same_bits(g, w)


# ------------------------------------------------------------------- K4
def _adasum_close(got, a, b):
    """Within ``chip_smoke.py``'s ``ADASUM_RTOL`` bound of the twin, NaN
    where the twin has NaN."""
    from chip_smoke import adasum_error

    want = ck.adasum_combine_pairs_plain(a, b)
    assert got.dtype == a.dtype and got.shape == want.shape
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert adasum_error(got, want, a, b)[1] <= 1.0


def _adasum_sets(gen):
    """Pair sets the kernel's paths part at: one unit, several parts, a
    unit of several tiles (past 192 tiles of 48 KB), bf16 and f16, and a
    tree level's strided rows with an odd n (element loads)."""
    from chip_smoke import adasum_pairs

    sets = [adasum_pairs(m, n, gen, dt) for m, n, dt in (
        (1, 1, torch.float32), (2, 257, torch.float32),
        (3, 40000, torch.float32), (1, 3 * 2359296 + 5, torch.float32),
        (2, 1024, torch.bfloat16), (1, 5000000, torch.bfloat16),
        (2, 4096, torch.float16))]
    level = torch.stack(adasum_pairs(4, 999, gen), 1).reshape(8, 999)
    sets.append((level[0::2], level[1::2]))
    return sets


def test_adasum_single_and_grouped_match_twin():
    """Each pair set alone and all of them in one grouped call (one launch
    a dtype) within the twin's bound; a set gives the same bits alone and
    inside the table, and two grouped launches the same bytes."""
    sets = _adasum_sets(_gen())
    single = [ck.adasum_combine_pairs(a, b) for a, b in sets]
    assert ck.launch_counts()["adasum_combine_pairs"] == len(sets)
    ck.reset_launch_counts()
    grouped = ck.adasum_combine_pairs_many(sets)
    again = ck.adasum_combine_pairs_many(sets)
    assert ck.launch_counts()["adasum_combine_pairs"] == 2 * 3
    torch.cuda.synchronize()
    for (a, b), s, g, g2 in zip(sets, single, grouped, again):
        _adasum_close(s, a, b)
        assert _same_bits(g, s) and _same_bits(g2, g)


def test_adasum_zero_and_nan_rows_as_the_twin():
    """(0, b) -> b, (a, 0) -> a, (0, 0) -> 0 exactly; a NaN takes its whole
    row and no other, alone and in a table."""
    from chip_smoke import adasum_pairs

    gen = _gen()
    a, b = adasum_pairs(3, 50000, gen)
    a[0] = 0
    b[1] = 0
    a[2] = b[2] = 0
    x, y = adasum_pairs(2, 50000, gen)
    x[1, 17] = float("nan")
    for got in ([ck.adasum_combine_pairs(a, b), ck.adasum_combine_pairs(x, y)],
                ck.adasum_combine_pairs_many([(a, b), (x, y)])):
        zero, nan = got
        assert _same_bits(zero[0], b[0]) and _same_bits(zero[1], a[1])
        assert not zero[2].any()
        assert torch.isnan(nan[1]).all() and torch.isfinite(nan[0]).all()
        _adasum_close(nan, x, y)


def test_adasum_table_over_the_limit_counts_its_launches():
    """More pair sets than a table holds take one launch a table-full and
    the bits of each set's own call."""
    from chip_smoke import adasum_pairs

    per_table = ck._kernel("hvd_adasum_table_entries")[1]()
    gen = _gen()
    sets = [adasum_pairs(1, 100 + 37 * i, gen) for i in range(per_table + 5)]
    got = ck.adasum_combine_pairs_many(sets)
    assert ck.launch_counts()["adasum_combine_pairs"] == 2
    for (a, b), g in zip(sets, got):
        assert _same_bits(g, ck.adasum_combine_pairs(a, b))


def test_adasum_launches_from_a_fresh_thread():
    """The single-pair and grouped calls from a thread that has made no
    CUDA runtime call give the main thread's bytes."""
    import threading

    sets = _adasum_sets(_gen())[:4]

    def calls():
        return [ck.adasum_combine_pairs(*sets[2])] + \
            ck.adasum_combine_pairs_many(sets)

    want = calls()
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["out"] = calls()
        except Exception as e:  # reported by the main thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    assert "error" not in got, got.get("error")
    torch.cuda.synchronize()
    for g, w in zip(got["out"], want):
        assert _same_bits(g, w)


# ------------------------------------------------ the engine on the card
def test_engine_waits_for_the_producer_stream():
    """A tensor produced on the current stream after a long spin of it,
    enqueued at once: the engine's stream waits for the producer, and the
    caller's stream waits for the result (world 1, in place and not)."""
    import horovod_tpu_torch as hvd

    hvd.init()
    try:
        x = torch.zeros(1 << 22, device="cuda")
        y = torch.zeros(1 << 22, device="cuda")
        torch.cuda._sleep(100_000_000)
        x.fill_(3.0)
        y.fill_(5.0)
        h = hvd.allreduce_async(x, op=hvd.Sum, name="race")
        hi = hvd.allreduce_async_(y, name="race_")
        out = hvd.synchronize(h)
        assert hvd.synchronize(hi) is y
        total = (out.sum() + y.sum()).item()  # on the caller's stream
        assert total == 8.0 * (1 << 22)
        assert bool((out == 3.0).all()) and bool((y == 5.0).all())
    finally:
        hvd.shutdown()


def test_adasum_launches_k4_on_the_engine_stream():
    """Two gloo ranks on the card: an Adasum allreduce launches K4 from the
    engine thread on its own stream, counted in ``launch_counts()``, and
    both ranks hold the combine of the numpy oracle."""
    import numpy as np

    from horovod_tpu_torch import testing
    from torch_engine_workers import cuda_adasum_worker

    ranks = testing.run_cluster(cuda_adasum_worker, np=2, device="cuda",
                                timeout=300)
    xs = [np.random.RandomState(5 + r).randn(4099).astype(np.float32)
          for r in range(2)]
    want = testing.numpy_adasum([x.astype(np.float64) for x in xs])
    for r in ranks:
        assert r["launches"] == 1
        assert r["seen"] == [(r["engine_stream"], "hvd_torch_engine")]
        assert r["engine_stream"] != r["main_stream"]
        np.testing.assert_allclose(r["y"], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ranks[0]["y"], ranks[1]["y"])


# ------------------------------------- K9 from device scalars; the graph
@pytest.mark.parametrize("leaves", [3, 40, 600])
def test_adamw_device_scalars_give_the_host_scalar_bits(leaves):
    """K9 reading [lr, ibc1, ibc2] from a device buffer gives the bits of
    its host-scalar call, for tables of both sizes and over the limit of
    one launch (600 leaves: two launches)."""
    gen = _gen()
    sizes = [1 + (97 * i) % 5000 for i in range(leaves)]
    ps = [torch.randn(n, generator=gen, device="cuda") for n in sizes]
    gs = [torch.randn_like(p) for p in ps]
    mus = [torch.randn(n, generator=gen, device="cuda").to(torch.bfloat16)
           for n in sizes]
    nus = [torch.rand(n, generator=gen, device="cuda") for n in sizes]
    copy = [[t.clone() for t in ts] for ts in (ps, mus, nus)]
    sc = dict(lr=3e-4, ibc1=10.0, ibc2=1000.0)
    ck.adamw_update(ps, gs, mus, nus, b1=0.9, b2=0.999, eps=1e-8,
                    weight_decay=0.01, **sc)
    host = ck.launch_counts()["adamw_update"]
    scalars = torch.tensor([sc["lr"], sc["ibc1"], sc["ibc2"]],
                           device="cuda")
    ck.adamw_update(copy[0], gs, copy[1], copy[2], b1=0.9, b2=0.999,
                    eps=1e-8, weight_decay=0.01, scalars=scalars)
    assert ck.launch_counts()["adamw_update"] == 2 * host
    assert host == -(-leaves // 512)
    for got, want in zip(copy, (ps, mus, nus)):
        for a, b in zip(got, want):
            assert _same_bits(a, b)


@pytest.fixture
def port_card():
    import horovod_tpu_torch as hvd

    hvd.init()
    yield hvd
    hvd.shutdown()


def _lm_case(fused: bool, graph: bool):
    """A 2-layer bf16 LM (head dim 64: K5 and K7 on wgmma; fused: K8 and
    K9) and its compiled step."""
    from horovod_tpu_torch import spmd
    from horovod_tpu_torch.models.transformer import TransformerLM, lm_loss
    from horovod_tpu_torch.optim.fused import FusedAdamW

    net = TransformerLM(512, num_layers=2, num_heads=2, d_model=128,
                        max_seq_len=128, dtype=torch.bfloat16,
                        fused_ln=fused, seed=3).cuda()
    if fused:
        opt = FusedAdamW(net.parameters(), lr=3e-4, weight_decay=0.01,
                         mu_dtype="bf16", capturable=True)
    else:
        opt = torch.optim.AdamW(net.parameters(), lr=3e-4, weight_decay=0.01,
                                fused=True, capturable=True)
    step = spmd.make_train_step(lambda x, y: lm_loss(net(x), y), opt, net,
                                graph=graph)
    return net, opt, step


def _resnet_case(graph: bool):
    """A ResNet-18 of width 8 on the int8 wire (#1 and #2 a step) with a
    fused SGD (its lr a device tensor under the graph)."""
    from horovod_tpu_torch import spmd
    from horovod_tpu_torch.models import resnet

    net = resnet.ResNet18(num_classes=10, num_filters=8, seed=0).cuda()
    opt = torch.optim.SGD(net.parameters(), lr=0.05, momentum=0.9,
                          fused=True)

    def loss_fn(x, y):
        with torch.autocast("cuda", dtype=torch.bfloat16,
                            cache_enabled=False):
            logits = net(x)
        return torch.nn.functional.cross_entropy(logits.float(), y)

    step = spmd.make_train_step(loss_fn, opt, net, compression="int8",
                                graph=graph)
    return net, opt, step


def _graphed_against_eager(make, batch, lrs):
    """3 steps graphed and eager from the same weights, the lr set before
    each: (losses, params) of both, and the graphed step."""
    out = {}
    for graph in (False, True):
        torch.manual_seed(0)
        net, opt, step = make(graph)
        losses = []
        for lr in lrs:
            opt.param_groups[0]["lr"] = lr
            losses.append(float(step(*batch)))
        torch.cuda.synchronize()
        out[graph] = (losses, [p.detach().float().cpu()
                               for p in net.parameters()], step)
    return out


def _agree(out, lrs):
    """Graphed against eager: losses to 1e-4 relative; 99.9% of the
    parameter elements within 1e-6 and every one within 2 * sum(lr) (what
    updates of opposite sign could open where an atomic sum's order flips
    a gradient's last bit)."""
    (le, pe, _), (lg, pg, _) = out[False], out[True]
    assert all(abs(a - b) <= 1e-4 * abs(a) for a, b in zip(le, lg)), (le, lg)
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pe, pg)])
    assert float((diffs <= 1e-6).float().mean()) >= 0.999
    assert float(diffs.max()) <= 2 * sum(lrs)


@pytest.mark.parametrize("fused", [False, True], ids=["default", "fused"])
def test_graphed_lm_step_matches_eager_with_a_changing_lr(port_card, fused):
    from horovod_tpu_torch.train import synthetic_lm_tokens

    toks = torch.from_numpy(synthetic_lm_tokens(4, 128, 512, 0, 1)).cuda()
    batch = (toks[:, :-1].contiguous(), toks[:, 1:].contiguous())
    lrs = [3e-4, 1e-4, 5e-4]
    out = _graphed_against_eager(lambda g: _lm_case(fused, g), batch, lrs)
    _agree(out, lrs)
    step = out[True][2]
    assert step.graphed and not out[False][2].graphed
    want = {"flash_attention_fwd": 2, "flash_attention_bwd": 2}
    if fused:
        want.update(layer_norm_fwd=5, adamw_update=1)
    assert step.launches_per_replay == want


def test_graphed_resnet_step_matches_eager_with_a_changing_lr(port_card):
    from horovod_tpu_torch.train import synthetic_batch

    images, labels = synthetic_batch(4, 32, 10, 0, 1)
    batch = (torch.from_numpy(images).cuda(), torch.from_numpy(labels).cuda())
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        lrs = [0.05, 0.02, 0.08]
        out = _graphed_against_eager(_resnet_case, batch, lrs)
    finally:
        torch.backends.cudnn.deterministic = det
    _agree(out, lrs)
    step = out[True][2]
    assert step.launches_per_replay == {"int8_quantize_2d": 1,
                                        "int8_dequantize_2d": 1}
    ck.reset_launch_counts()
    step(*batch)
    assert ck.launch_counts()["int8_quantize_2d"] == 1
    assert float(step.ef.abs().max()) > 0


def test_graphed_step_refuses_what_it_cannot_replay(port_card):
    """A parameter whose storage changed, an lr change that SGD without
    ``fused`` froze, and AdamW without ``capturable``: each raises."""
    from horovod_tpu_torch import spmd

    w = torch.nn.Parameter(torch.randn(300, 4, device="cuda"))
    x = torch.randn(8, 300, device="cuda")
    opt = torch.optim.SGD([w], lr=0.1, momentum=0.9)
    step = spmd.make_train_step(lambda a: (a @ w).square().mean(), opt, [w],
                                graph=True)
    step(x)
    opt.param_groups[0]["lr"] = 0.2
    with pytest.raises(RuntimeError, match="froze"):
        step(x)
    opt.param_groups[0]["lr"] = 0.1
    step(x)
    w.data = w.data.clone()
    with pytest.raises(RuntimeError, match="storage"):
        step(x)
    adamw = torch.optim.AdamW([w], lr=0.1)
    bad = spmd.make_train_step(lambda a: (a @ w).square().mean(), adamw, [w],
                               graph=True)
    with pytest.raises(ValueError, match="capturable"):
        bad(x)


def test_hop_dequantize_add_on_the_card_is_one_f32_rounding():
    """A quantized hop's ``q * scale + local`` on the card (one f32
    ``addcmul``) against the CPU's float64 route (the product exact, one
    rounding): within one unit in the last place of each element."""
    from horovod_tpu_torch import spmd

    gen = torch.Generator().manual_seed(0)
    q = torch.randint(-127, 128, (64, 256), dtype=torch.int8, generator=gen)
    scales = torch.rand(64, 1, generator=gen) * 1e-2
    local = torch.randn(64 * 256, generator=gen)
    want = spmd._dequant_add(q, scales, local)
    got = spmd._dequant_add(q.cuda(), scales.cuda(), local.cuda()).cpu()
    assert got.dtype == torch.float32 and got.shape == want.shape
    ulp = torch.nextafter(want.abs(), torch.tensor(float("inf"))) - want.abs()
    assert bool(((got - want).abs() <= ulp).all())


@pytest.mark.parametrize("mode,bits", [("int4", 4), ("int8", 8),
                                       ("bf16", 16)])
def test_adaptive_roundtrip_and_observation_on_the_card(mode, bits,
                                                        monkeypatch):
    """The adaptive wire's error-feedback roundtrip at the selector's most
    aggressive grid: on the card (one grouped #1 and one #2 at 8 bits)
    bit for bit the CPU twin's; the selector observes a CUDA tensor as its
    CPU copy (only the sample crosses to the host)."""
    import numpy as np

    from horovod_tpu_torch.ops import adaptive
    from horovod_tpu_torch.ops.compression import AdaptiveCompressor

    monkeypatch.setenv("HOROVOD_ADAPTIVE_INTERVAL", "1")
    monkeypatch.setenv("HOROVOD_ADAPTIVE_TOL",
                       "0.001" if mode == "bf16" else "0.2")
    adaptive.reset()
    AdaptiveCompressor.reset()
    g = torch.randn(8192, generator=_gen(), device="cuda")
    AdaptiveCompressor.observe("b", g ** 3 if mode == "int8" else g)
    cpu = adaptive.BitwidthSelector()
    cpu.observe("b", (g ** 3 if mode == "int8" else g).cpu())
    assert AdaptiveCompressor.selector().decisions() == cpu.decisions() \
        == {"b": mode}
    xs = [torch.randn(n, generator=_gen(), device="cuda") * 10.0 ** e
          for n, e in ((5000, -2), (256, 0), (77, 1))]
    ck.reset_launch_counts()
    ys = AdaptiveCompressor.roundtrip_many(xs)
    if bits == 8:
        counts = ck.launch_counts()
        assert counts["int8_quantize_2d"] == counts["int8_dequantize_2d"] == 1
    twins = AdaptiveCompressor.roundtrip_many([x.cpu() for x in xs])
    for y, t in zip(ys, twins):
        assert np.array_equal(y.cpu().numpy(), t.numpy())
    adaptive.reset()
    AdaptiveCompressor.reset()
