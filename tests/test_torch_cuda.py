"""PyTorch port, on a CUDA card: the hand-written kernels against their
plain versions. Every test is marked ``cuda`` and skips without a card;
this file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel computes in f32 and rounds only its output, so it is held
against the plain version on the same inputs widened to f32, elementwise
|kernel - plain| <= rtol * |plain| + atol: in f32 atol 1e-4 (summation
order); in bf16 also half a bf16 step of the output, rtol 2^-8, atol 1e-5.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref as tref

# (b, sq, sk, hq, hkv, causal, window, sink, q_offset); every row attends
# at least one key
FLASH_CASES = [
    (2, 24, 24, 4, 4, True, 0, 0, 0),
    (2, 24, 24, 4, 2, True, 0, 0, 0),
    (1, 33, 33, 8, 2, True, 8, 2, 0),
    (1, 16, 40, 4, 2, True, 0, 0, 24),
    (1, 16, 40, 4, 1, True, 6, 3, 24),
    (1, 12, 20, 2, 1, False, 0, 0, 0),
    (2, 200, 200, 8, 2, True, 64, 4, 0),
]

CARD_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -8, 1e-5)}


def _widened(*ts):
    return [t.float() for t in ts]


def _within(got, want, dtype) -> bool:
    rtol, atol = CARD_TOL[dtype]
    return bool(((got.float() - want).abs() <= rtol * want.abs() + atol).all())


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel(cuda_dev, dtype, d, case):
    b, sq, sk, hq, hkv, causal, window, sink, off = case
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    q = _rand(gen, cuda_dev, dtype, b, sq + 70, hq, d)
    k = _rand(gen, cuda_dev, dtype, b, sk + 70, hkv, d)
    v = _rand(gen, cuda_dev, dtype, b, sk + 70, hkv, d)
    kw = dict(causal=causal, window=window, sink=sink, q_offset=off)
    got = ops.flash_attention(q, k, v, **kw)
    want = tref.flash_attention_ref(*_widened(q, k, v), **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _within(got, want, dtype)


@pytest.mark.cuda
def test_flash_attention_kernel_fully_masked_row_is_zero(cuda_dev):
    q = torch.randn(1, 8, 2, 32, device=cuda_dev)
    k = torch.randn(1, 8, 1, 32, device=cuda_dev)
    out = ops.flash_attention(q, k, k, causal=True, window=2, q_offset=20)
    assert out.abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_paged_attention_kernel(cuda_dev, dtype, d, group):
    gen = torch.Generator(device=cuda_dev).manual_seed(group)
    b, hkv, t = 2, 3, 301
    q = _rand(gen, cuda_dev, dtype, b, hkv * group, d)
    k = _rand(gen, cuda_dev, dtype, b, hkv, t, d)
    v = _rand(gen, cuda_dev, dtype, b, hkv, t, d)
    valid = torch.rand(b, hkv, t, generator=gen, device=cuda_dev) < 0.5
    valid[1, 2] = False
    got = ops.paged_attention(q, k, v, valid)
    want = tref.paged_attention_ref(*_widened(q, k, v), valid)
    torch.cuda.synchronize()
    assert _within(got, want, dtype)
    assert got[1, 2 * group:].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 4])
def test_page_score_kernel(cuda_dev, dtype, d, group):
    gen = torch.Generator(device=cuda_dev).manual_seed(group)
    b, hkv, c = 2, 3, 75
    q = _rand(gen, cuda_dev, dtype, b, hkv * group, d)
    lo = torch.randn(b, hkv, c, d, generator=gen, device=cuda_dev)
    hi = torch.randn(b, hkv, c, d, generator=gen, device=cuda_dev)
    tmin, tmax = torch.minimum(lo, hi), torch.maximum(lo, hi)
    tmin[:, :, 60:], tmax[:, :, 60:] = float("inf"), float("-inf")
    got = ops.page_score(q, tmin, tmax)
    want = tref.page_score_ref(q, tmin, tmax)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    fin = want.isfinite()
    assert (got[fin] - want[fin]).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_kernel_wrappers_count_and_validate(cuda_dev):
    ops.reset_launches()
    q = torch.randn(1, 4, 64, device=cuda_dev)
    k = torch.randn(1, 2, 10, 64, device=cuda_dev)
    valid = torch.ones(1, 2, 10, dtype=torch.bool, device=cuda_dev)
    ops.paged_attention(q, k, k, valid)
    assert ops.LAUNCHES["paged_attention"] == 1
    with pytest.raises(ValueError, match="contiguous"):
        ops.paged_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), k, valid)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                            k[..., :48].contiguous(), valid)
    assert ops.LAUNCHES["paged_attention"] == 1


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
def test_generate_on_the_card_matches_the_cpu_and_counts_launches(cuda_dev):
    """A reduced llama3-8b served on the card (kernels) and on the CPU
    (plain versions) from the same weights: same greedy tokens, close
    logits, and exactly the kernel launches the lockstep path makes."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    cfg = reduced(get_arch("llama3-8b"))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(3),
                           device="cpu")
    on_card = _to(params, cuda_dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 37),
                            generator=torch.Generator().manual_seed(4))
    gen, cap = 9, 37 + 9 + cfg.h2eal.page_size
    toks_cpu, st_cpu = generate(cfg, params, prompts, gen=gen, capacity=cap,
                                device="cpu")
    ops.reset_launches()
    toks, st = generate(cfg, on_card, prompts, gen=gen, capacity=cap,
                        device=cuda_dev)
    n_sel = -(-gen // cfg.h2eal.share_window)
    assert ops.LAUNCHES == {"flash_attention": 2 * cfg.num_layers,
                            "page_score": n_sel * cfg.num_layers,
                            "paged_attention": 2 * gen * cfg.num_layers,
                            "chunk_attention": 0, "chunk_attention_paged": 0,
                            "paged_attention_partial": 0, "combine_partials": 0}
    assert torch.equal(toks.cpu(), toks_cpu)
    assert (st["last_logits"].cpu() - st_cpu["last_logits"]).abs().max().item() <= 1e-3


# (b, cq, hkv, t, group): query tiles that straddle chunk positions (group
# 3), a single-row group, and a T that is not a multiple of the key tile
CHUNK_CASES = [(2, 7, 2, 29, 1), (1, 33, 2, 100, 3), (2, 64, 1, 301, 4),
               (1, 20, 2, 64, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", CHUNK_CASES)
def test_chunk_attention_kernel(cuda_dev, dtype, d, case):
    b, cq, hkv, t, group = case
    gen = torch.Generator(device=cuda_dev).manual_seed(t)
    q = _rand(gen, cuda_dev, dtype, b, cq, hkv * group, d)
    k = _rand(gen, cuda_dev, dtype, b, hkv, t, d)
    v = _rand(gen, cuda_dev, dtype, b, hkv, t, d)
    valid = torch.rand(b, hkv, cq, t, generator=gen, device=cuda_dev) < 0.3
    valid[:, :, :, 64:] = False      # whole key tiles without a valid key
    valid[0, 0, cq // 2] = False     # an all-invalid row gives 0
    got = ops.chunk_attention(q, k, v, valid)
    want = tref.chunk_attention_ref(*_widened(q, k, v), valid)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _within(got, want, dtype)
    assert got[0, cq // 2, :group].abs().max().item() == 0.0


def _paged_inputs(gen, dev, dtype, b, cq, hr, group, c, p, d, written, order):
    q = _rand(gen, dev, dtype, b, cq, hr * group, d)
    kp = _rand(gen, dev, dtype, b, hr, c, p, d)
    vp = _rand(gen, dev, dtype, b, hr, c, p, d)
    w = torch.tensor(written, device=dev)
    first = torch.arange(c, device=dev) * p
    ps = torch.where(first[None] < w[:, None], first[None], -1).to(torch.int32)
    ps = ps[:, None, :].expand(b, hr, c)[..., order].contiguous()
    kn = _rand(gen, dev, dtype, b, cq, hr, d)
    vn = _rand(gen, dev, dtype, b, cq, hr, d)
    return q, kp, vp, ps, kn, vn


# (b, cq, hr, group, c, p, written per slot, start per slot)
PAGED_CASES = [
    (2, 6, 2, 2, 7, 8, (0, 0), (0, 0)),          # start 0: the chunk alone
    (2, 64, 2, 4, 9, 32, (200, 77), (190, 77)),  # partial last page, keys >= start
    (1, 40, 1, 3, 20, 8, (150,), (150,)),        # group 3 straddles chunk rows
    (3, 100, 2, 1, 5, 16, (80, 0, 33), (80, 0, 33)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("case", PAGED_CASES)
def test_chunk_attention_paged_kernel(cuda_dev, dtype, d, case):
    b, cq, hr, group, c, p, written, start = case
    gen = torch.Generator(device=cuda_dev).manual_seed(c * p)
    ins = _paged_inputs(gen, cuda_dev, dtype, b, cq, hr, group, c, p, d, written,
                        torch.arange(c))
    st = torch.tensor(start, dtype=torch.int32, device=cuda_dev)
    q, kp, vp, ps, kn, vn = ins
    got = ops.chunk_attention_paged(q, kp, vp, ps, st, kn, vn)
    want = tref.chunk_attention_paged_ref(*_widened(q, kp, vp), ps, st,
                                          *_widened(kn, vn))
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _within(got, want, dtype)


@pytest.mark.cuda
def test_chunk_attention_paged_kernel_takes_pages_in_any_order(cuda_dev):
    """Validity comes from page_start, never from a page's index."""
    gen = torch.Generator(device=cuda_dev).manual_seed(5)
    c = 12
    order = torch.randperm(c, generator=torch.Generator().manual_seed(0))
    q, kp, vp, ps, kn, vn = _paged_inputs(gen, cuda_dev, torch.float32, 2, 9, 2, 2,
                                          c, 8, 64, (70, 41), order)
    st = torch.tensor([70, 41], dtype=torch.int32, device=cuda_dev)
    got = ops.chunk_attention_paged(q, kp, vp, ps, st, kn, vn)
    want = tref.chunk_attention_paged_ref(q, kp, vp, ps, st, kn, vn)
    torch.cuda.synchronize()
    assert _within(got, want, torch.float32)
    assert ops.LAUNCHES["chunk_attention_paged"] >= 1


@pytest.mark.cuda
def test_engine_on_the_card_matches_the_cpu_and_reads_nothing_back(cuda_dev):
    """A reduced llama3-8b engine, chunked with churn, on the card (kernels)
    and on the CPU (plain versions): same tokens; each kernel launched once
    a layer per step of its kind; and neither chunked admission nor an
    engine step synchronises with the card (CUDA sync debug mode set to
    error, which catches the synchronising operations PyTorch flags)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    cfg = reduced(get_arch("llama3-8b"))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(3),
                           device="cpu")
    rng = torch.Generator().manual_seed(4)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab_size, (n,),
                                                generator=rng).numpy(),
                    max_new=m)
            for i, (n, m) in enumerate([(37, 9), (20, 4), (51, 6), (9, 7)])]
    kw = dict(max_batch=2, capacity=80, prompt_buckets=[64], prefill_chunk=7)
    cpu = Engine(cfg, params, device="cpu", **kw).run(reqs)
    eng = Engine(cfg, _to(params, cuda_dev), device=cuda_dev, **kw)
    for r in reqs:
        eng.submit(r)
    ops.reset_launches()
    while eng.busy():  # chunked admission and every step
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.poll()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    eng.finalize()
    s, n = eng.stats, cfg.num_layers
    assert ops.LAUNCHES == {"flash_attention": 0, "page_score": s.select_steps * n,
                            "paged_attention": 2 * s.decode_steps * n,
                            "chunk_attention": s.prefill_chunks * n,
                            "chunk_attention_paged": s.prefill_chunks * n,
                            "paged_attention_partial": 0, "combine_partials": 0}
    assert {u: c.tokens for u, c in eng.completions.items()} == {
        u: c.tokens for u, c in cpu.items()}


def _partial_within(got, want) -> bool:
    """The partial's outputs are f32 on both sides and differ by summation
    order alone; they reach the attention output divided by l, so l and o
    are held to the f32 tolerance in units of max(l, 1)."""
    (m, l, o), (wm, wl, wo) = got, want
    atol = CARD_TOL[torch.float32][1]
    scale = wl.clamp(min=1.0)
    return (bool(((m - wm).abs() <= atol * wm.abs().clamp(min=1.0)).all())
            and bool(((l - wl).abs() <= atol * scale).all())
            and bool(((o - wo).abs() <= atol * scale[..., None]).all()))


def _stripe_inputs(gen, dev, dtype, s, b, hkv, group, c, p, n, d):
    """Stripe slot lists as the coplace_shmap decode builds them: random
    page slots, each kept only on the stripe that owns it (slot // (C/S)),
    -1 elsewhere; validity random on owned slots."""
    q = _rand(gen, dev, dtype, b, hkv * group, d)
    kp = _rand(gen, dev, dtype, b, hkv, c, p, d)
    vp = _rand(gen, dev, dtype, b, hkv, c, p, d)
    slots = torch.randint(0, c, (b, hkv, n), generator=gen, device=dev)
    stripe = torch.arange(s, device=dev)[:, None, None, None]
    mine = slots[None] // (c // s) == stripe
    slots = torch.where(mine, slots[None], -1).to(torch.int32)
    valid = (torch.rand(s, b, hkv, n, p, generator=gen, device=dev) < 0.7) & mine[..., None]
    return q, kp, vp, slots, valid.reshape(s, b, hkv, n * p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("group", [1, 3, 4, 8])
def test_paged_attention_partial_kernel(cuda_dev, dtype, d, group):
    gen = torch.Generator(device=cuda_dev).manual_seed(group)
    s, b, hkv, c, p, n = 4, 2, 3, 24, 8, 45
    q, kp, vp, slots, valid = _stripe_inputs(gen, cuda_dev, dtype, s, b, hkv, group,
                                             c, p, n, d)
    valid[2, 1, 0] = False   # a row with no valid token on one stripe
    valid[:, 0, 2] = False   # ... and on every stripe
    got = ops.paged_attention_partial(q, kp, vp, slots, valid)
    want = tref.paged_attention_partial_pages_ref(*_widened(q, kp, vp), slots, valid)
    torch.cuda.synchronize()
    assert all(t.dtype == torch.float32 for t in got)
    assert _partial_within(got, want)
    m, l, o = got
    for empty in (m[2, 1, :group], m[:, 0, 2 * group:3 * group]):
        assert bool((empty == -1e30).all())
    assert l[2, 1, :group].abs().max().item() == 0.0
    assert o[:, 0, 2 * group:3 * group].abs().max().item() == 0.0
    out = ops.combine_partials(*got)
    assert out[0, 2 * group:3 * group].abs().max().item() == 0.0


@pytest.mark.cuda
def test_paged_attention_partial_kernel_at_main_path_width(cuda_dev):
    """S=8 stripes of a 264-page cache, 138 slots of 32 tokens (llama3-8b's
    [sink | 128 selected | local] list), group 4, D=128, bf16."""
    gen = torch.Generator(device=cuda_dev).manual_seed(9)
    args = _stripe_inputs(gen, cuda_dev, torch.bfloat16, 8, 4, 4, 4, 264, 32, 138, 128)
    got = ops.paged_attention_partial(*args)
    want = tref.paged_attention_partial_pages_ref(*_widened(*args[:3]), *args[3:])
    torch.cuda.synchronize()
    assert _partial_within(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 8])
def test_combine_partials_kernel(cuda_dev, n):
    gen = torch.Generator(device=cuda_dev).manual_seed(n)
    b, hq, d = 3, 8, 128
    m = torch.randn(n, b, hq, generator=gen, device=cuda_dev) * 4
    l = torch.rand(n, b, hq, generator=gen, device=cuda_dev) * 50
    o = torch.randn(n, b, hq, d, generator=gen, device=cuda_dev) * 10
    m[0, 1, 2], l[0, 1, 2], o[0, 1, 2] = -1e30, 0.0, 0.0   # an empty partial
    m[:, 2, 5], l[:, 2, 5], o[:, 2, 5] = -1e30, 0.0, 0.0   # a row empty everywhere
    ops.reset_launches()
    got = ops.combine_partials(m, l, o)
    want = tref.combine_partials_ref(m, l, o)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["combine_partials"] == 1
    assert got.dtype == torch.float32 and _within(got, want, torch.float32)
    assert got[2, 5].abs().max().item() == 0.0
    with pytest.raises(ValueError, match="float32"):
        ops.combine_partials(m, l, o.to(torch.bfloat16))


@pytest.mark.cuda
def test_coplace_engine_on_the_card_matches_the_cpu_and_reads_nothing_back(cuda_dev):
    """The coplace_shmap engine over 4 stripes with balanced admission,
    chunked with churn: the CPU's tokens and admission reorders; the
    retrieval heads go through the partial and combine kernels once a layer
    a decode step; no step synchronises with the card."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    cfg = reduced(get_arch("llama3-8b"))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(7),
                           device="cpu")
    rng = torch.Generator().manual_seed(8)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab_size, (n,),
                                                generator=rng).numpy(),
                    max_new=m)
            for i, (n, m) in enumerate([(37, 9), (20, 4), (51, 6), (9, 7), (30, 5)])]
    kw = dict(max_batch=2, capacity=96, prompt_buckets=[64], prefill_chunk=7,
              layout="coplace_shmap", shards=4, admission="balanced")
    cpu_eng = Engine(cfg, params, device="cpu", **kw)
    cpu = cpu_eng.run(reqs)
    eng = Engine(cfg, _to(params, cuda_dev), device=cuda_dev, **kw)
    for r in reqs:
        eng.submit(r)
    ops.reset_launches()
    while eng.busy():
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.poll()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    eng.finalize()
    s, n = eng.stats, cfg.num_layers
    assert ops.LAUNCHES == {"flash_attention": 0, "page_score": s.select_steps * n,
                            "paged_attention": s.decode_steps * n,
                            "chunk_attention": s.prefill_chunks * n,
                            "chunk_attention_paged": s.prefill_chunks * n,
                            "paged_attention_partial": s.decode_steps * n,
                            "combine_partials": s.decode_steps * n}
    assert s.admission_reorders == cpu_eng.stats.admission_reorders
    assert {u: c.tokens for u, c in eng.completions.items()} == {
        u: c.tokens for u, c in cpu.items()}
