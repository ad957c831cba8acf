"""PyTorch port, on a CUDA card: the hand-written kernels against their
plain versions. Every test is marked ``cuda`` and skips without a card;
this file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Each kernel computes in f32 and rounds only its output, so it is held
against the plain version on the same inputs widened to f32, elementwise
|kernel - plain| <= rtol * |plain| + atol: in f32 atol 1e-4 (summation
order); in bf16 also half a bf16 step of the output, rtol 2^-8, atol 1e-5.
The bf16 tensor-core kernels (flash_attention, chunk_attention,
chunk_attention_paged) also round the unnormalised P (each p in [0, 1]) to
bf16 before P·V, which moves the output by at most 2^-8·(softmax(s)·|V|):
they are held to that term on top (``_p_within``), the plain version run
on |v| giving softmax(s)·|V|.
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
    (1, 40, 40, 32, 2, True, 8, 2, 0),       # group 16 (qwen3-moe)
    (2, 40, 40, 14, 2, True, 0, 0, 0),       # group 7 (internvl2-1b)
    (1, 50, 50, 7, 1, True, 8, 2, 0),        # group 7, window and sink
    (1, 40, 40, 32, 32, True, 0, 0, 0),      # MHA, 32 heads (musicgen-large)
]

CARD_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -8, 1e-5)}
# every head_dim the kernels take; 80 is zamba2-2.7b's, 256 gemma3-1b's
HEAD_DIMS = [32, 64, 80, 128, 256]


def _widened(*ts):
    return [t.float() for t in ts]


def _within(got, want, dtype) -> bool:
    rtol, atol = CARD_TOL[dtype]
    return bool(((got.float() - want).abs() <= rtol * want.abs() + atol).all())


def _p_within(got, plain, args, values) -> bool:
    """A tensor-core kernel against ``plain(*args)`` on widened inputs; in
    bf16 with the P-rounding term 2^-8·(softmax(s)·|V|): ``plain`` on the
    same inputs with the value operands (``args`` at the indices
    ``values``) replaced by their absolute values."""
    want = plain(*_widened(*args))
    if got.dtype == torch.float32:
        return _within(got, want, torch.float32)
    rtol, atol = CARD_TOL[torch.bfloat16]
    p_term = plain(*_widened(*(a.abs() if i in values else a for i, a in enumerate(args))))
    return bool(((got.float() - want).abs()
                 <= 2.0 ** -8 * p_term + rtol * want.abs() + atol).all())


def _flash_within(got, q, k, v, **kw) -> bool:
    return _p_within(got, lambda *a: tref.flash_attention_ref(*a, **kw), (q, k, v), (2,))


def _chunk_within(got, q, k, v, valid) -> bool:
    return _p_within(got, lambda q, k, v: tref.chunk_attention_ref(q, k, v, valid),
                     (q, k, v), (2,))


def _chunk_paged_within(got, q, kp, vp, ps, st, kn, vn) -> bool:
    return _p_within(
        got, lambda q, kp, vp, kn, vn: tref.chunk_attention_paged_ref(q, kp, vp, ps, st, kn, vn),
        (q, kp, vp, kn, vn), (2, 4))


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(gen, dev, dtype, *shape):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel(cuda_dev, dtype, d, case):
    b, sq, sk, hq, hkv, causal, window, sink, off = case
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    q = _rand(gen, cuda_dev, dtype, b, sq + 70, hq, d)
    k = _rand(gen, cuda_dev, dtype, b, sk + 70, hkv, d)
    v = _rand(gen, cuda_dev, dtype, b, sk + 70, hkv, d)
    kw = dict(causal=causal, window=window, sink=sink, q_offset=off)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _flash_within(got, q, k, v, **kw)


# the bf16 tensor-core kernel's edges (q tiles of 128 rows, key tiles of 128):
# (b, sq, sk, hq, hkv, causal, window, sink, q_offset); every row attends a key
FLASH_BF16_CASES = [
    (1, 1, 1, 8, 1, True, 0, 0, 0),          # Sq = 1, group 8
    (1, 1, 300, 4, 1, True, 0, 0, 299),      # one query at the end of 300 keys
    (2, 300, 300, 8, 2, True, 0, 0, 0),      # ragged q and key tiles, group 4
    (1, 257, 390, 8, 1, True, 0, 0, 133),    # q_offset > 0, group 8
    (1, 300, 300, 4, 4, True, 100, 0, 0),    # a window across tiles, group 1
    (1, 300, 300, 8, 2, True, 150, 4, 0),    # window and sink
    (2, 520, 520, 4, 1, True, 256, 4, 0),    # serving's window: tiles are skipped
    (1, 129, 200, 4, 1, False, 0, 0, 0),     # not causal, ragged
    # the ping-pong schedule's edges: a single key tile; odd numbers of key
    # tiles (3 and 5); Sq not a multiple of 128 with window + sink
    (1, 64, 64, 4, 1, True, 0, 0, 0),
    (2, 384, 384, 8, 2, True, 0, 0, 0),
    (1, 200, 640, 4, 2, False, 0, 0, 0),
    (1, 100, 600, 4, 1, True, 0, 0, 500),
    (1, 700, 700, 8, 2, True, 256, 4, 0),
    # group 16 (qwen3-moe): full causal, and the streaming heads' window + sink
    (2, 300, 300, 32, 2, True, 0, 0, 0),
    (1, 520, 520, 16, 1, True, 256, 4, 0),
    # group 7 (internvl2-1b: 14 query heads over 2 kv heads) on the group-8
    # tiles, full causal and the streaming heads' window + sink; MHA with
    # 32 + 32 heads (musicgen-large)
    (2, 300, 300, 14, 2, True, 0, 0, 0),
    (1, 520, 520, 7, 1, True, 256, 4, 0),
    (1, 300, 300, 32, 32, True, 0, 0, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", FLASH_BF16_CASES)
def test_flash_attention_bf16_kernel_edges(cuda_dev, d, case):
    b, sq, sk, hq, hkv, causal, window, sink, off = case
    gen = torch.Generator(device=cuda_dev).manual_seed(sq + sk)
    q = _rand(gen, cuda_dev, torch.bfloat16, b, sq, hq, d)
    k = _rand(gen, cuda_dev, torch.bfloat16, b, sk, hkv, d)
    v = _rand(gen, cuda_dev, torch.bfloat16, b, sk, hkv, d)
    kw = dict(causal=causal, window=window, sink=sink, q_offset=off)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert _flash_within(got, q, k, v, **kw)


@pytest.mark.cuda
def test_flash_attention_bf16_kernel_at_serving_length(cuda_dev):
    """B=2, S=4096, 8 q heads over 2 kv heads, D=128: 32 q tiles of causal
    depth up to 32 key tiles, through the TMA ring many times."""
    gen = torch.Generator(device=cuda_dev).manual_seed(11)
    q = _rand(gen, cuda_dev, torch.bfloat16, 2, 4096, 8, 128)
    k = _rand(gen, cuda_dev, torch.bfloat16, 2, 4096, 2, 128)
    v = _rand(gen, cuda_dev, torch.bfloat16, 2, 4096, 2, 128)
    got = ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert _flash_within(got, q, k, v, causal=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_kernel_fully_masked_row_is_zero(cuda_dev, dtype, d):
    q = torch.randn(1, 8, 2, d, device=cuda_dev).to(dtype)
    k = torch.randn(1, 8, 1, d, device=cuda_dev).to(dtype)
    out = ops.flash_attention(q, k, k, causal=True, window=2, q_offset=20)
    assert out.abs().max().item() == 0.0


# flash_attention's backward (csrc/flash_attention_bwd.cu and, in bf16,
# csrc/flash_attention_bwd_sm90.cu): (b, s, hq, hkv, causal, window, sink,
# q_offset); S ragged (no multiple of the 128-row, 32- to 128-key tiles); GQA
# groups 1, 3 (smollm-360m), 4 (llama3-8b) and 16; causal, window 256 + sink 4
# (llama3-8b's streaming heads), window 512 (gemma3-1b); a window with sinks
# over S = 2048, where launch 2 cuts key tile 0's walk into runs (6 to 8)
FLASH_BWD_CASES = [
    (2, 77, 4, 4, True, 0, 0, 0),
    (1, 150, 15, 5, True, 0, 0, 0),
    (1, 300, 8, 2, True, 256, 4, 0),
    (1, 601, 16, 1, True, 512, 0, 0),
    (1, 601, 3, 1, True, 256, 4, 0),
    (1, 40, 8, 2, True, 6, 3, 24),
    (1, 33, 4, 1, False, 0, 0, 0),
    (2, 2048, 4, 2, True, 64, 4, 0),
    (2, 150, 14, 2, True, 0, 0, 0),          # group 7 (internvl2-1b)
    (1, 77, 32, 32, True, 0, 0, 0),          # MHA, 32 heads (musicgen-large)
]


def _bwd_within(got, want, dtype) -> bool:
    """The backward against its plain version: 1e-4·max|plain| + 1e-5 (the
    summation order and 3xTF32's 2^-20 a product; dq and dk are sums that
    cancel), and in bf16 2^-8·|plain| more for the output's rounding (the
    sources' notes derive it)."""
    want = want.float()
    lim = 1e-4 * want.abs().max() + 1e-5
    if dtype == torch.bfloat16:
        lim = lim + 2.0 ** -8 * want.abs()
    return bool(((got.float() - want).abs() <= lim).all())


def _bwd_inputs(dev, dtype, b, s, hq, hkv, d, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (_rand(gen, dev, dtype, b, s, hq, d), _rand(gen, dev, dtype, b, s, hkv, d),
            _rand(gen, dev, dtype, b, s, hkv, d), _rand(gen, dev, dtype, b, s, hq, d))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_flash_attention_bwd_kernel(cuda_dev, dtype, d, case):
    """The backward kernels against their plain version (and, in f32,
    against autograd through the plain forward), bit for bit the same on a
    rerun; the forward's L against ``ref.flash_attention_lse_ref``, and its
    output bit for bit the same with and without the L pointer."""
    b, s, hq, hkv, causal, window, sink, off = case
    kw = dict(causal=causal, window=window, sink=sink, q_offset=off)
    q, k, v, do = _bwd_inputs(cuda_dev, dtype, b, s, hq, hkv, d)
    with torch.no_grad():
        o, lse = ops.flash_attention_lse(q, k, v, **kw)
        assert torch.equal(o, ops.flash_attention(q, k, v, **kw))
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    want_lse = tref.flash_attention_lse_ref(*_widened(q, k), **kw)
    assert lse.shape == (b, hq, s) and torch.equal(lse.isinf(), want_lse.isinf())
    fin = want_lse.isfinite()
    assert ((lse[fin] - want_lse[fin]).abs() <= 1e-5 * want_lse[fin].abs() + 1e-5).all()
    want = tref.flash_attention_bwd_ref(*_widened(q, k, v, o, do), **kw)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        assert _bwd_within(g, w, dtype)
    if dtype == torch.float32:  # the plain version is autograd's gradient
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        auto = torch.autograd.grad(tref.flash_attention_ref(*leaves, **kw), leaves, do)
        for g, a in zip(got, auto):
            assert _bwd_within(g, a, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_lse_of_a_row_with_no_key(cuda_dev, dtype, d):
    """A row with no allowed key: output 0 with or without L, L = -inf, and
    the backward gives it dq = 0 (its P is 0)."""
    q, k, v, do = _bwd_inputs(cuda_dev, dtype, 1, 8, 2, 1, d, seed=3)
    kw = dict(causal=True, window=2, q_offset=20)
    with torch.no_grad():
        o, lse = ops.flash_attention_lse(q, k, v, **kw)
    assert o.abs().max().item() == 0.0 and bool((lse == -torch.inf).all())
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert dq.abs().max().item() == 0.0 and dk.abs().max().item() == 0.0
    assert dv.abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_runs_the_kernels(cuda_dev, dtype):
    """With grad on and an input requiring grad, ops.flash_attention is an
    autograd node: one forward launch (with L), and its backward one call of
    the backward kernels, equal to ops.flash_attention_bwd on the forward's
    output and L and deterministic (bit for bit on a rerun). Under no_grad,
    or with no input requiring grad, the forward alone, as serving runs it."""
    q, k, v, do = _bwd_inputs(cuda_dev, dtype, 2, 200, 8, 2, 64, seed=1)
    kw = dict(causal=True, window=64, sink=4)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launches()
    out = ops.flash_attention(*leaves, **kw)
    assert out.grad_fn is not None and ops.LAUNCHES["flash_attention"] == 1
    grads = torch.autograd.grad(out, leaves, do)
    assert ops.LAUNCHES["flash_attention_bwd"] == 1
    with torch.no_grad():
        o, lse = ops.flash_attention_lse(q, k, v, **kw)
    assert torch.equal(o, out.detach())
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    for g, a in zip(grads, again):
        assert torch.equal(g, a)
    with torch.no_grad():
        plain = ops.flash_attention(*leaves, **kw)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())
    assert ops.flash_attention(q, k, v, **kw).grad_fn is None
    assert ops.LAUNCHES["flash_attention"] == 4 and ops.LAUNCHES["flash_attention_bwd"] == 2


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_dev):
    """Two make_train_step steps of reduced smollm-360m (remat) on the card
    against the CPU on the same weights and batches: losses and grad norms
    within 1e-5 relative; 2 forward and 1 backward launch a layer a step."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data import lm_batch
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw
    from repro_torch.runtime import train as train_rt

    cfg = reduced(get_arch("smollm-360m"))
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    step_fn = train_rt.make_train_step(cfg, train_rt.TrainConfig(lr=1e-3, warmup=1))
    out = {}
    for dev in ("cpu", cuda_dev):
        p = _to(params, dev)
        opt = adamw.init_state(p)
        ops.reset_launches()
        out[str(dev)] = []
        for step in range(2):
            batch = {k: t.to(dev) for k, t in
                     lm_batch(step, batch=2, seq=64, vocab=cfg.vocab_size).items()}
            p, opt, m = step_fn(p, opt, batch, step)
            out[str(dev)].append((m["loss"].item(), m["grad_norm"].item()))
    assert ops.LAUNCHES["flash_attention"] == 2 * 2 * cfg.num_layers
    assert ops.LAUNCHES["flash_attention_bwd"] == 2 * cfg.num_layers
    for (a, b), (c, d) in zip(out["cpu"], out[str(cuda_dev)]):
        assert abs(c - a) <= 1e-5 * abs(a) and abs(d - b) <= 1e-5 * abs(b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 2, 3, 4, 7, 8, 12, 16])
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


# (b, hkv, t, group): the split-KV grid's edges. T below two splits' worth
# (one split); T not a multiple of the 32-key unit; B·Hkv under 66 (two
# splits of the 300 keys); B·Hkv > 66 (one split a stream); 16 splits of
# 8-9 units
PAGED_SPLIT_CASES = [(1, 2, 100, 4), (2, 3, 1000, 3), (40, 4, 300, 2),
                     (70, 4, 600, 4), (2, 4, 4416, 4), (2, 2, 4416, 16),
                     (2, 1, 4416, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 4, 7, 8, 16])
@pytest.mark.parametrize("p", [8, 32])
def test_paged_attention_pages_kernel(cuda_dev, dtype, d, group, p):
    """Decode attention read through a page table (pages of 8: a 32-key unit
    spans four pages; of 32: one), five splits: sentinel slots (-1, C, past
    C) whose tokens are invalid, as paging.token_validity makes them, and so
    never loaded; a sentinel whose tokens are valid, read from its clamped
    slot as ref.gather_pages reads it; a row with no valid token; two
    back-to-back calls equal bit for bit (the arrival counters were reset)."""
    gen = torch.Generator(device=cuda_dev).manual_seed(group * d + p)
    b, hkv, c = 2, 3, 160 // p * 4
    n = 640 // p
    q = _rand(gen, cuda_dev, dtype, b, hkv * group, d)
    kp = _rand(gen, cuda_dev, dtype, b, hkv, c, p, d)
    vp = _rand(gen, cuda_dev, dtype, b, hkv, c, p, d)
    slots = torch.randint(0, c, (b, hkv, n), generator=gen, device=cuda_dev,
                          dtype=torch.int32)
    valid = torch.rand(b, hkv, n, p, generator=gen, device=cuda_dev) < 0.7
    for bi, hi, i, slot in ((0, 1, 3, -1), (1, 0, 7, c), (1, 2, n - 1, c + 5)):
        slots[bi, hi, i] = slot
        valid[bi, hi, i] = False
    slots[0, 0, 2] = -1                 # valid tokens: the clamped slot 0 is read
    valid[1, 1] = False                 # a row with no valid token
    valid = valid.reshape(b, hkv, n * p)
    assert ops.paged_splits(b, hkv, n * p) == 5
    ops.reset_launches()
    got = ops.paged_attention_pages(q, kp, vp, slots, valid)
    again = ops.paged_attention_pages(q, kp, vp, slots, valid)
    want = tref.paged_attention_pages_ref(*_widened(q, kp, vp), slots, valid)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention"] == 2
    assert got.dtype == dtype and _within(got, want, dtype)
    assert got[1, group:2 * group].abs().max().item() == 0.0
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "paged_attention"])
def test_kernels_on_two_streams_at_once(cuda_dev, kernel):
    """The bf16 flash kernel's work-item counters and paged_attention's
    arrival counters are kept per (device, stream): launches that overlap on
    two streams give what each gives alone, bit for bit."""
    gen = torch.Generator(device=cuda_dev).manual_seed(5)
    bf = torch.bfloat16
    if kernel == "flash_attention":
        args = [(_rand(gen, cuda_dev, bf, 2, 2048, 8, 128),
                 _rand(gen, cuda_dev, bf, 2, 2048, 2, 128),
                 _rand(gen, cuda_dev, bf, 2, 2048, 2, 128)) for _ in range(2)]
        call = lambda a: ops.flash_attention(*a, causal=True)
    else:
        args = [(_rand(gen, cuda_dev, bf, 2, 16, 128),
                 _rand(gen, cuda_dev, bf, 2, 4, 4416, 128),
                 _rand(gen, cuda_dev, bf, 2, 4, 4416, 128),
                 torch.rand(2, 4, 4416, generator=gen, device=cuda_dev) < 0.9)
                for _ in range(2)]
        call = lambda a: ops.paged_attention(*a)
    alone = [call(a) for a in args]
    streams = [torch.cuda.Stream(cuda_dev) for _ in args]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_dev))
    together = [[], []]
    for _ in range(4):
        for i, (s, a) in enumerate(zip(streams, args)):
            with torch.cuda.stream(s):
                together[i].append(call(a))
    torch.cuda.synchronize()
    for want, outs in zip(alone, together):
        assert all(torch.equal(out, want) for out in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", PAGED_SPLIT_CASES)
def test_paged_attention_split_kernel(cuda_dev, dtype, d, case):
    b, hkv, t, group = case
    n = ops.paged_splits(b, hkv, t)
    units = -(-t // 32)  # split s takes the units of 32 keys [s·U/n, (s+1)·U/n)
    beg, end = 32 * (units // n), 32 * (2 * units // n)
    gen = torch.Generator(device=cuda_dev).manual_seed(t)
    q = _rand(gen, cuda_dev, dtype, b, hkv * group, d)
    k = _rand(gen, cuda_dev, dtype, b, hkv, t, d)
    v = _rand(gen, cuda_dev, dtype, b, hkv, t, d)
    valid = torch.rand(b, hkv, t, generator=gen, device=cuda_dev) < 0.8
    if n > 1:
        valid[0, 0, beg:end] = False          # a split with no valid key
    valid[-1, -1] = False                     # an all-invalid row gives 0
    got = ops.paged_attention(q, k, v, valid)
    again = ops.paged_attention(q, k, v, valid)  # the counters were reset
    want = tref.paged_attention_ref(*_widened(q, k, v), valid)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _within(got, want, dtype)
    assert got[-1, -group:].abs().max().item() == 0.0
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 4, 7, 12, 16])
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
    # f32 sums of 2·g·D products in two orders: 1e-4 up to D = 128 and g = 4;
    # the sum and its rounding grow with the terms summed (scores ~500 at
    # D = 256, g = 4, where one f32 step is 6.1e-5), so 1e-4 per 128
    # coordinates and per 4 rows of the group
    tol = 1e-4 * max(1, d // 128) * max(1, group // 4)
    assert (got[fin] - want[fin]).abs().max().item() <= tol


# page_select: (b, hkv, group, c, d, page, ctx, top_k, stripes, need, ties).
# ctx an int or one per row; stripes S > 0: the coplace_shmap layout (page
# slots striped over S stripes, minus_one_masked); need: the rows that take
# the new selection (None: all); ties: τ rows repeat every 5 pages, so their
# scores tie exactly, and the last row's q is 0, so all its scores tie at 0
SELECT_CASES = [
    (2, 4, 4, 258, 128, 32, 8193, 128, 0, None, False),          # lockstep
    (4, 4, 4, 258, 128, 32, [8200, 7000, 5000, 3000], 128, 0,
     [True, True, False, True], False),                           # engine
    (4, 4, 4, 264, 128, 32, [8200, 7000, 5000, 3000], 128, 8,
     [True, False, True, True], False),                           # coplace
    (2, 3, 1, 75, 64, 8, [500, 301], 16, 0, None, True),          # ties, C % 8
    (2, 3, 1, 75, 64, 8, [500, 301], 16, 5, [False, True], True),
    (2, 2, 8, 40, 32, 4, [60, 150], 32, 0, None, False),          # < K selectable
    (2, 2, 8, 40, 32, 4, [60, 150], 32, 4, None, False),
    (3, 2, 2, 20, 64, 16, [300, 20, 100], 32, 0, None, False),    # K >= C, all masked
    (3, 2, 2, 20, 64, 16, [300, 20, 100], 32, 4, None, False),
    (1, 2, 4, 4096, 128, 32, 4096 * 32, 128, 0, None, False),     # C = 4096
    (1, 1, 4, 16384, 128, 32, 16384 * 32, 128, 8, None, False),   # the C limit
    (4, 1, 4, 514, 256, 32, [16448, 9000, 4100, 700], 128, 0,
     [True, False, True, True], False),                           # gemma3-1b engine
    (2, 1, 4, 514, 256, 32, [500, 301], 16, 0, None, True),       # D = 256, ties
    # group 16 (qwen3-moe: 2 retrieval heads of 16 query heads each)
    (4, 2, 16, 258, 128, 32, [8200, 7000, 5000, 3000], 128, 0,
     [True, True, False, True], False),                           # engine
    (4, 2, 16, 264, 128, 32, [8200, 7000, 5000, 3000], 128, 8,
     [True, False, True, True], False),                           # coplace
    (2, 3, 16, 75, 32, 8, [500, 301], 16, 0, None, True),         # ties, D = 32
    # head_dim 80 (zamba2-2.7b: 16 retrieval heads of group 1)
    (4, 16, 1, 258, 80, 32, [8200, 7000, 5000, 3000], 128, 0,
     [True, True, False, True], False),                           # engine
    (4, 16, 1, 264, 80, 32, [8200, 7000, 5000, 3000], 128, 8,
     [True, False, True, True], False),                           # coplace
    (2, 2, 4, 75, 80, 8, [500, 301], 16, 0, None, True),          # ties, group 4
    # group 7 (internvl2-1b: 1 retrieval head of 7 query heads, D = 64) on
    # the group-8 lanes, and MHA at D = 64 (musicgen-large: 16 retrieval heads)
    (2, 1, 7, 258, 64, 32, 8193, 128, 0, None, False),            # lockstep
    (4, 1, 7, 258, 64, 32, [8200, 7000, 5000, 3000], 128, 0,
     [True, True, False, True], False),                           # engine
    (2, 3, 7, 75, 64, 8, [500, 301], 16, 0, None, True),          # ties
    (4, 16, 1, 258, 64, 32, [8200, 7000, 5000, 3000], 128, 0,
     [True, True, False, True], False),                           # engine, MHA
]
SCORE_RTOL = 1e-6  # the scores are f32 sums on both sides: of the row's max |score|


def _select_inputs(gen, dev, dtype, case):
    b, hkv, group, c, d, page, ctx, top_k, stripes, need, ties = case
    q = _rand(gen, dev, dtype, b, hkv * group, d)
    lo = torch.randn(b, hkv, c, d, generator=gen, device=dev)
    hi = torch.randn(b, hkv, c, d, generator=gen, device=dev)
    if ties:
        lo, hi = lo[:, :, torch.arange(c) % 5], hi[:, :, torch.arange(c) % 5]
        q[-1] = 0
    tmin, tmax = torch.minimum(lo, hi).contiguous(), torch.maximum(lo, hi).contiguous()
    ctx_t = torch.tensor(ctx if isinstance(ctx, list) else [ctx] * b, device=dev)
    logical = torch.arange(c, device=dev)
    if stripes:
        from repro_torch.core import paging
        logical = paging.logical_pages(c, stripes, dev)
    start = (logical * page)[None, None].expand(b, hkv, c)
    start = torch.where(start < ctx_t[:, None, None] - 1, start, -1).to(torch.int32)
    empty = (start < 0)[..., None]
    tmin = torch.where(empty, float("inf"), tmin).contiguous()
    tmax = torch.where(empty, float("-inf"), tmax).contiguous()
    ctx = ctx_t.to(torch.int32) if isinstance(ctx, list) else ctx
    need = None if need is None else torch.tensor(need, device=dev)
    return q, tmin, tmax, start.contiguous(), ctx, need


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SELECT_CASES)
def test_page_select_kernel(cuda_dev, dtype, case):
    """The fused select step: its selection is the stable top-k of its own
    scores (read back as imp - 0 on the selectable pages), exactly, in the
    layout's form (coplace: also the two-stage per-stripe form); its scores
    lie within SCORE_RTOL of the plain version's; with a previous selection
    and importance, the rows that need no selection keep them bit for bit
    and the others add the scores; and rows of the plain version's
    selection without a near-tie are the kernel's."""
    b, hkv, group, c, d, page, _, top_k, stripes, _, _ = case
    gen = torch.Generator(device=cuda_dev).manual_seed(c + b)
    q, tmin, tmax, start, ctx, need = _select_inputs(gen, cuda_dev, dtype, case)
    kw = dict(sink=4, local=256 if page == 32 else 3 * page, page=page, top_k=top_k,
              minus_one_masked=bool(stripes))
    zeros = torch.zeros(b, hkv, c, device=cuda_dev)
    sel_prev = torch.randint(-1, c, (b, hkv, top_k), generator=gen, device=cuda_dev,
                             dtype=torch.int32)
    ops.reset_launches()
    sel0, imp0 = ops.page_select(q, tmin, tmax, start, ctx, sel_prev, zeros, **kw)
    imp_prev = torch.randn(b, hkv, c, generator=gen, device=cuda_dev)
    sel1, imp1 = ops.page_select(q, tmin, tmax, start, ctx, sel_prev, imp_prev, need, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["page_score"] == 2

    ok = tref.selectable_pages(start, ctx, sink=4, local=kw["local"], page=page).cpu()
    own = torch.where(ok, imp0.cpu(), tref.NEG_INF)
    assert torch.equal(imp0.cpu()[~ok], torch.zeros(int((~ok).sum())))
    flag = dict(minus_one_masked=bool(stripes))
    assert torch.equal(sel0.cpu(), tref.select_top_k(own, top_k, **flag))
    if stripes:
        assert torch.equal(sel0.cpu(), tref.select_top_k(own, top_k, shards=stripes, **flag))

    plain = torch.where(ok, tref.page_score_ref(*_widened(q, tmin, tmax)).cpu(), tref.NEG_INF)
    band = SCORE_RTOL * torch.where(ok, plain.abs(), 0.0).amax(dim=-1, keepdim=True)
    assert bool((torch.where(ok, (own - plain).abs(), 0.0) <= band).all())

    rows = torch.ones(b, dtype=torch.bool) if need is None else need.cpu()
    keep = ~rows
    assert torch.equal(sel1.cpu()[keep], sel_prev.cpu()[keep])
    assert torch.equal(imp1.cpu()[keep], imp_prev.cpu()[keep])
    assert torch.equal(sel1.cpu()[rows], sel0.cpu()[rows])
    want = imp_prev.cpu() + torch.where(ok, plain, 0.0)
    assert bool(((imp1.cpu() - want).abs()[rows] <= 2 * band[rows] + 1e-6 * want.abs()[rows]).all())

    ref_sel, _ = tref.page_select_ref(*_widened(q, tmin, tmax), start, ctx, sel_prev,
                                      zeros, **kw)
    # a row is clear of near-ties where every gap between its plain top
    # min(K, C) + 1 scores is wider than the scores' error, masked pairs aside
    top = plain.sort(dim=-1, descending=True).values[..., : min(top_k, c) + 1]
    hi, lo = top[..., :-1], top[..., 1:]
    clear = ((hi - lo > 2 * band) | (hi <= tref.NEG_INF_HALF)).all(dim=-1)
    assert bool((ref_sel.cpu() == sel0.cpu()).all(dim=-1)[clear].all())


@pytest.mark.cuda
def test_page_select_refuses_above_its_limits(cuda_dev):
    q = torch.randn(1, 4, 128, device=cuda_dev)
    for c, top_k, msg in ((ops._MAX_SELECT_PAGES + 1, 128, "limit of 16384"),
                          (64, ops._MAX_SELECT_K + 1, "top_k")):
        tau = torch.zeros(1, 1, c, 128, device=cuda_dev)
        with pytest.raises(ValueError, match=msg):
            ops.page_select(q, tau, tau, torch.zeros(1, 1, c, dtype=torch.int32,
                                                     device=cuda_dev),
                            10_000, torch.zeros(1, 1, top_k, dtype=torch.int32,
                                                device=cuda_dev),
                            torch.zeros(1, 1, c, device=cuda_dev), sink=4, local=256,
                            page=32, top_k=top_k)


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
                            "paged_attention_partial": 0, "combine_partials": 0,
                            "flash_attention_bwd": 0}
    assert torch.equal(toks.cpu(), toks_cpu)
    assert (st["last_logits"].cpu() - st_cpu["last_logits"]).abs().max().item() <= 1e-3


# (b, cq, hkv, t, group): query tiles that straddle chunk positions (group
# 3), a single-row group, and a T that is not a multiple of the key tile
CHUNK_CASES = [(2, 7, 2, 29, 1), (1, 33, 2, 100, 3), (2, 64, 1, 301, 4),
               (1, 20, 2, 64, 8), (1, 20, 2, 100, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
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
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _chunk_within(got, q, k, v, valid)
    assert got[0, cq // 2, :group].abs().max().item() == 0.0


# the bf16 tensor-core kernel's edges (q tiles of 64 // group whole chunk
# positions, key tiles of 128): (b, cq, hkv, t, group), each under a
# streaming head's mask (sink 4 + a window of 100 before each position,
# thinned at random) with one all-invalid row. T = 804 (the main path's
# ring 292 + chunk 512) is read 4 validity bytes a lane, odd T a byte a
# lane; Cq not a multiple of 64 // group leaves a ragged last q tile
CHUNK_BF16_CASES = [(2, 50, 2, 804, 4), (1, 45, 2, 301, 3), (1, 20, 2, 129, 8),
                    (1, 70, 1, 803, 1), (2, 512, 1, 804, 4), (2, 50, 2, 804, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", CHUNK_BF16_CASES)
def test_chunk_attention_bf16_kernel_edges(cuda_dev, d, case):
    b, cq, hkv, t, group = case
    gen = torch.Generator(device=cuda_dev).manual_seed(t + cq)
    q = _rand(gen, cuda_dev, torch.bfloat16, b, cq, hkv * group, d)
    k = _rand(gen, cuda_dev, torch.bfloat16, b, hkv, t, d)
    v = _rand(gen, cuda_dev, torch.bfloat16, b, hkv, t, d)
    pos_q = torch.arange(cq, device=cuda_dev)[:, None] + (t - cq)
    j = torch.arange(t, device=cuda_dev)[None, :]
    valid = (j <= pos_q) & ((j < 4) | (j > pos_q - 100))
    valid = valid & (torch.rand(b, hkv, cq, t, generator=gen, device=cuda_dev) < 0.9)
    valid[-1, -1, cq - 1] = False    # an all-invalid row gives 0
    got = ops.chunk_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert _chunk_within(got, q, k, v, valid)
    assert got[-1, cq - 1, -group:].abs().max().item() == 0.0


def _paged_inputs(gen, dev, dtype, b, cq, hr, group, c, p, d, written, order):
    """Pages written up to ``written`` tokens a slot; physical slot i holds
    logical page order[i]."""
    q = _rand(gen, dev, dtype, b, cq, hr * group, d)
    kp = _rand(gen, dev, dtype, b, hr, c, p, d)
    vp = _rand(gen, dev, dtype, b, hr, c, p, d)
    w = torch.tensor(written, device=dev)
    first = order.to(dev) * p
    ps = torch.where(first[None] < w[:, None], first[None], -1).to(torch.int32)
    ps = ps[:, None, :].expand(b, hr, c).contiguous()
    kn = _rand(gen, dev, dtype, b, cq, hr, d)
    vn = _rand(gen, dev, dtype, b, cq, hr, d)
    return q, kp, vp, ps, kn, vn


# (b, cq, hr, group, c, p, written per slot, start per slot)
PAGED_CASES = [
    (2, 6, 2, 2, 7, 8, (0, 0), (0, 0)),          # start 0: the chunk alone
    (2, 64, 2, 4, 9, 32, (200, 77), (190, 77)),  # partial last page, keys >= start
    (1, 40, 1, 3, 20, 8, (150,), (150,)),        # group 3 straddles chunk rows
    (3, 100, 2, 1, 5, 16, (80, 0, 33), (80, 0, 33)),
    (2, 20, 2, 16, 9, 32, (200, 77), (190, 77)),  # group 16 (qwen3-moe)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", PAGED_CASES)
def test_chunk_attention_paged_kernel(cuda_dev, dtype, d, case):
    b, cq, hr, group, c, p, written, start = case
    gen = torch.Generator(device=cuda_dev).manual_seed(c * p)
    ins = _paged_inputs(gen, cuda_dev, dtype, b, cq, hr, group, c, p, d, written,
                        torch.arange(c))
    st = torch.tensor(start, dtype=torch.int32, device=cuda_dev)
    q, kp, vp, ps, kn, vn = ins
    got = ops.chunk_attention_paged(q, kp, vp, ps, st, kn, vn)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _chunk_paged_within(got, q, kp, vp, ps, st, kn, vn)


# the bf16 tensor-core kernel's edges: (b, cq, hr, group, c, p, written per
# slot, start per slot, page order). 128-key tiles over pages of 32 that are
# partly written (written 200: keys 200..223 of page 6 lie at >= start
# 190), start 0 beside a long slot, groups 3 and 8, Cq not a multiple of
# 64 // group, chunks over more than one 128-key tile, pages in
# coplace_shmap's striped order over 4 stripes and in random order
CHUNK_PAGED_BF16_CASES = [
    (2, 50, 2, 4, 12, 32, (200, 0), (190, 0), "in order"),
    (1, 130, 2, 3, 20, 32, (600,), (590,), "striped"),
    (2, 40, 1, 8, 12, 32, (384, 100), (384, 100), "striped"),
    (1, 300, 1, 1, 8, 16, (100,), (99,), "random"),
    (4, 512, 1, 4, 40, 32, (0, 300, 1000, 1270), (0, 300, 1000, 1270), "striped"),
    (2, 50, 2, 16, 12, 32, (200, 0), (190, 0), "striped"),       # group 16
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", CHUNK_PAGED_BF16_CASES)
def test_chunk_attention_paged_bf16_kernel_edges(cuda_dev, d, case):
    from repro_torch.core import paging

    b, cq, hr, group, c, p, written, start, order = case
    order = {"in order": torch.arange(c),
             "striped": paging.logical_pages(c, 4, "cpu"),
             "random": torch.randperm(c, generator=torch.Generator().manual_seed(c))}[order]
    gen = torch.Generator(device=cuda_dev).manual_seed(c * p + cq)
    q, kp, vp, ps, kn, vn = _paged_inputs(gen, cuda_dev, torch.bfloat16, b, cq, hr, group,
                                          c, p, d, written, order)
    st = torch.tensor(start, dtype=torch.int32, device=cuda_dev)
    got = ops.chunk_attention_paged(q, kp, vp, ps, st, kn, vn)
    torch.cuda.synchronize()
    assert _chunk_paged_within(got, q, kp, vp, ps, st, kn, vn)


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
                            "paged_attention_partial": 0, "combine_partials": 0,
                            "flash_attention_bwd": 0}
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
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 3, 4, 7, 8, 16])
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


def _coplace_inputs(gen, dev, dtype, s, b, hkv, group, c, p, n, d):
    """An unsplit attended list as the coplace_shmap decode hands it over:
    random page slots (a -1 sentinel and a slot past C among them, both
    invalid), validity random on the real slots; in row (0, 0) the last
    stripe owns no slot (its slots moved to stripe 0), and row (B-1, Hkv-1)
    has no valid token."""
    q = _rand(gen, dev, dtype, b, hkv * group, d)
    kp = _rand(gen, dev, dtype, b, hkv, c, p, d)
    vp = _rand(gen, dev, dtype, b, hkv, c, p, d)
    slots = torch.randint(0, c, (b, hkv, n), generator=gen, device=dev)
    if s > 1:
        c_own = c // s
        row = slots[0, 0]
        slots[0, 0] = torch.where(row >= (s - 1) * c_own, row % c_own, row)
    slots[0, 1 % hkv, 2] = -1
    slots[-1, 0, 3] = c
    real = (slots >= 0) & (slots < c)
    valid = (torch.rand(b, hkv, n, p, generator=gen, device=dev) < 0.7) & real[..., None]
    valid[-1, -1] = False
    return q, kp, vp, slots.to(torch.int32), valid.reshape(b, hkv, n * p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("group", [1, 4, 7, 8, 16])
@pytest.mark.parametrize("s", [1, 4, 8])
@pytest.mark.parametrize("p", [8, 32])
def test_paged_attention_coplace_kernel(cuda_dev, dtype, d, group, s, p):
    """The co-placed decode in one launch (stripes split and merged in it)
    against the plain composition: each stripe's partial, combined, cast."""
    gen = torch.Generator(device=cuda_dev).manual_seed(group * 100 + s * 10 + p)
    b, hkv, c, n = 2, 3, 24, 45
    q, kp, vp, slots, valid = _coplace_inputs(gen, cuda_dev, dtype, s, b, hkv, group,
                                              c, p, n, d)
    ops.reset_launches()
    got = ops.paged_attention_coplace(q, kp, vp, slots, valid, s)
    want = tref.paged_attention_coplace_ref(*_widened(q, kp, vp), slots, valid, s)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_attention_partial"] == 1
    assert ops.LAUNCHES["combine_partials"] == 0 and ops.LAUNCHES["paged_attention"] == 0
    assert got.dtype == dtype and _within(got, want, dtype)
    assert got[-1, -group:].abs().max().item() == 0.0
    assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
def test_paged_attention_coplace_kernel_at_main_path_width(cuda_dev):
    """S=8 stripes of a 264-page cache, 138 slots of 32 tokens, group 4,
    D=128, bf16: the coplace engine's decode shape at llama3-8b width."""
    gen = torch.Generator(device=cuda_dev).manual_seed(10)
    q, kp, vp, slots, valid = _coplace_inputs(gen, cuda_dev, torch.bfloat16, 8, 4, 4, 4,
                                              264, 32, 138, 128)
    got = ops.paged_attention_coplace(q, kp, vp, slots, valid, 8)
    want = tref.paged_attention_coplace_ref(*_widened(q, kp, vp), slots, valid, 8)
    torch.cuda.synchronize()
    assert _within(got, want, torch.bfloat16)


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
    retrieval heads make one co-placed launch a layer a decode step, merged
    in it (no combine launch); no step synchronises with the card."""
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
                            "combine_partials": 0, "flash_attention_bwd": 0}
    assert s.admission_reorders == cpu_eng.stats.admission_reorders
    assert {u: c.tokens for u, c in eng.completions.items()} == {
        u: c.tokens for u, c in cpu.items()}


def _window_launches(s, n, fused_len, split):
    """The kernel launches of an engine run from its step counts: each
    decode iteration a window runs launches as a step does, past a slot's
    budget too (the window's no-op iterations run the same kernels)."""
    decode = s.decode_steps - s.fused_steps + s.fused_windows * fused_len
    chunks = s.prefill_chunks - s.fused_chunks + s.fused_mixed_windows * fused_len
    return {"flash_attention": 0, "page_score": s.select_steps * n,
            "paged_attention": (1 if split else 2) * decode * n,
            "chunk_attention": chunks * n, "chunk_attention_paged": chunks * n,
            "paged_attention_partial": decode * n if split else 0,
            "combine_partials": 0, "flash_attention_bwd": 0}


def _serve_polled(eng, reqs):
    """Serve ``reqs`` a poll at a time, each under CUDA sync debug mode
    "error"; the counts of the launches made while serving."""
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
    return dict(ops.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("layout", ["default", "coplace_shmap"])
def test_captured_engine_matches_the_eager_engine(cuda_dev, layout, window):
    """The engine's steps replayed as CUDA graphs (the default on the card)
    against the same engine run eagerly on the card, chunked with churn and
    a widened share window of 4, per-step and with fused windows: the same
    tokens, the same kernel launches (a replay adds its graph's launches),
    each step captured once at construction and never again, and no poll
    synchronises with the card."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    cfg = reduced(get_arch("llama3-8b"))
    cfg = dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal,
                                                             share_window=4))
    params = _to(M.init_params(cfg, generator=torch.Generator().manual_seed(11),
                               device="cpu"), cuda_dev)
    rng = torch.Generator().manual_seed(12)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab_size, (n,),
                                                generator=rng).numpy(),
                    max_new=m)
            for i, (n, m) in enumerate([(37, 9), (20, 4), (51, 6), (9, 7), (30, 5)])]
    kw = dict(max_batch=2, capacity=96, prompt_buckets=[64], prefill_chunk=7,
              decode_window=window, device=cuda_dev)
    if layout == "coplace_shmap":
        kw.update(layout=layout, shards=4, admission="balanced")
    runs = {}
    for eager in (True, False):
        eng = Engine(cfg, params, eager=eager, **kw)
        sizes = eng.jit_cache_sizes()
        launches = _serve_polled(eng, reqs)
        assert eng.jit_cache_sizes() == sizes
        assert set(sizes.values()) == {0 if eager else 1}
        assert launches == _window_launches(eng.stats, cfg.num_layers,
                                            eng._fused_len, layout != "default")
        runs[eager] = ({u: c.tokens for u, c in eng.completions.items()}, launches,
                       eng.stats, eng.graph_replays())
    (tok_e, l_e, s_e, _), (tok_c, l_c, s_c, replays) = runs[True], runs[False]
    assert tok_c == tok_e and l_c == l_e
    assert dataclasses.replace(s_c, wall_s=0) == dataclasses.replace(s_e, wall_s=0)
    # every chunk, decode and window dispatch was a replay
    assert sum(replays.values()) == (s_c.prefill_chunks - s_c.fused_chunks
                                     + s_c.decode_steps - s_c.fused_steps
                                     + s_c.fused_windows)
    assert (s_c.fused_windows > 0) == (window is not None)


@pytest.mark.cuda
def test_captured_engine_reset_metrics_and_sync(cuda_dev):
    """reset_metrics and sync on a captured engine: a second run of the same
    requests after a reset gives the same tokens from the same graphs."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, Request

    cfg = reduced(get_arch("llama3-8b"))
    params = _to(M.init_params(cfg, generator=torch.Generator().manual_seed(13),
                               device="cpu"), cuda_dev)
    rng = torch.Generator().manual_seed(14)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab_size, (n,),
                                                generator=rng).numpy(),
                    max_new=m)
            for i, (n, m) in enumerate([(30, 6), (12, 5), (44, 3)])]
    eng = Engine(cfg, params, max_batch=2, capacity=80, prompt_buckets=[64],
                 prefill_chunk=8, decode_window=2, device=cuda_dev)
    sizes = eng.jit_cache_sizes()
    first = eng.run(reqs)
    eng.sync()
    replays = sum(eng.graph_replays().values())
    eng.reset_metrics()
    assert eng.stats.dispatches == 0 and not eng.completions
    again = eng.run(reqs)
    assert {u: c.tokens for u, c in again.items()} == {
        u: c.tokens for u, c in first.items()}
    assert sum(eng.graph_replays().values()) > replays > 0
    assert eng.jit_cache_sizes() == sizes


@pytest.mark.cuda
def test_capture_survives_the_collector_freeing_an_older_graph(cuda_dev):
    """A graph destroyed while another captures invalidates that capture. An
    engine's steps left in a reference cycle are freed by the cyclic
    collector whenever it runs, at any allocation: here it runs inside the
    capture. StepGraphs collects before a capture (and holds automatic
    collection off during it), so the older graph is gone by then."""
    import gc

    from repro_torch.runtime import graphs

    old = graphs.StepGraphs(cuda_dev)
    x = old.input("x", (4,), torch.float32)
    old.add("inc", lambda: x.add_(1))
    old.cycle = old  # freed only by the cyclic collector
    del old
    new = graphs.StepGraphs(cuda_dev)
    y = new.input("y", (4,), torch.float32)
    calls = []

    def step():
        calls.append(len(calls))
        if len(calls) == 2:  # the capture (the first call is the warm-up)
            gc.collect()
        return y.add_(1)

    new.add("inc", step)
    new.run("inc")
    torch.cuda.synchronize()
    assert y.tolist() == [2.0] * 4  # the warm-up and one replay


@pytest.mark.cuda
def test_sampler_bits_on_the_card_match_the_cpu(cuda_dev):
    """The threefry bits, keys and Gumbel values of the sampler on the card
    equal the CPU's (bits exactly, Gumbel within 2 ulp of max(|g|, 1)), and
    the greedy lane is the argmax."""
    import numpy as np

    from repro_torch.serving import sampling as S

    base = torch.stack([S.request_key(s, u) for s, u in ((0, 0), (3, 7), (2 ** 31 - 1, 1))])
    gen = torch.tensor([0, 5, 300], dtype=torch.int32)
    assert torch.equal(S.token_key(base.to(cuda_dev), gen.to(cuda_dev)).cpu(),
                       S.token_key(base, gen))
    assert torch.equal(S.random_bits(base.to(cuda_dev), (1000,)).cpu(),
                       S.random_bits(base, (1000,)))
    g, gd = S.gumbel(base, (1000,)), S.gumbel(base.to(cuda_dev), (1000,)).cpu()
    ulp = torch.from_numpy(np.spacing(np.maximum(g.abs().numpy(), 1.0).astype(np.float32)))
    assert bool(((gd - g).abs() <= 2 * ulp).all())
    logits = torch.randn(3, 1000, device=cuda_dev)
    toks = S.sample_tokens(logits, base.to(cuda_dev), gen.to(cuda_dev),
                           torch.zeros(3, device=cuda_dev), torch.ones(3, device=cuda_dev))
    assert torch.equal(toks, logits.argmax(-1).to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cq", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["retrieval", "streaming"])
def test_chunk_attention_kernel_at_verify_shapes(cuda_dev, dtype, cq, kind):
    """The verify step's chunk_attention: Cq = k chunk queries (fewer than a
    bf16 q tile's 16 positions at group 4) over a gathered buffer of T =
    4416 + k keys (retrieval) or 292 + k (streaming), the last k keys the
    chunk's own under a causal triangle; odd T takes the byte reads."""
    b, hkv, g, d = 2, 4, 4, 128
    t = (4416 if kind == "retrieval" else 292) + cq
    gen = torch.Generator(device=cuda_dev).manual_seed(t)
    q = _rand(gen, cuda_dev, dtype, b, cq, hkv * g, d)
    k = _rand(gen, cuda_dev, dtype, b, hkv, t, d)
    v = _rand(gen, cuda_dev, dtype, b, hkv, t, d)
    valid = torch.rand(b, hkv, cq, t, generator=gen, device=cuda_dev) < 0.5
    valid[..., t - cq:] = torch.ones(cq, cq, dtype=torch.bool, device=cuda_dev).tril()
    got = ops.chunk_attention(q, k, v, valid)
    torch.cuda.synchronize()
    assert _chunk_within(got, q, k, v, valid)


def _spec_engine_setup(cuda_dev):
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request

    cfg = reduced(get_arch("llama3-8b"))
    cfg = dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal, share_window=4))
    params = _to(M.init_params(cfg, generator=torch.Generator().manual_seed(16),
                               device="cpu"), cuda_dev)
    rng = torch.Generator().manual_seed(17)
    reqs = [Request(uid=i, prompt=torch.randint(0, cfg.vocab_size, (n,),
                                                generator=rng).numpy(),
                    max_new=m, temperature=0.8 * (i % 2), top_p=0.9, seed=2)
            for i, (n, m) in enumerate([(37, 9), (20, 4), (51, 6), (9, 7), (30, 5)])]
    return cfg, params, reqs


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["ngram", "streaming"])
@pytest.mark.parametrize("layout", ["default", "coplace_shmap"])
def test_captured_verify_step_matches_the_eager_one(cuda_dev, layout, draft):
    """The speculative engine (k = 4, greedy and sampled requests) with its
    verify step and draft replayed as CUDA graphs against the same engine
    run eagerly on the card: the same tokens, stats and kernel launches;
    each step captured once at construction; and the same tokens as the
    non-speculative captured engine."""
    import dataclasses

    from repro_torch.serving.engine import Engine

    cfg, params, reqs = _spec_engine_setup(cuda_dev)
    kw = dict(max_batch=2, capacity=96, prompt_buckets=[64], prefill_chunk=7,
              device=cuda_dev)
    if layout == "coplace_shmap":
        kw.update(layout=layout, shards=4)
    runs = {}
    for eager in (True, False):
        eng = Engine(cfg, params, eager=eager, spec_tokens=4, draft=draft, **kw)
        sizes = eng.jit_cache_sizes()
        assert set(sizes.values()) == {0 if eager else 1} and "verify" in sizes
        if draft == "streaming":
            assert {"draft_mask", "draft_decode"} <= set(sizes)
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        ops.reset_launches()
        eng.run()
        assert eng.jit_cache_sizes() == sizes
        runs[eager] = ({u: c.tokens for u, c in eng.completions.items()},
                       dict(ops.LAUNCHES), dataclasses.replace(eng.stats, wall_s=0))
    assert runs[True] == runs[False]
    base = Engine(cfg, params, **kw).run([dataclasses.replace(r) for r in reqs])
    assert runs[False][0] == {u: c.tokens for u, c in base.items()}


@pytest.mark.cuda
def test_captured_streaming_draft_leaves_the_state(cuda_dev):
    """A replayed streaming draft (the shadow copy, the -1 selection, three
    reuse steps) leaves the engine's serve state, token feed and generation
    indices bit for bit, and drafts the same tokens as an eager one."""
    from repro_torch.runtime import graphs
    from repro_torch.serving.engine import Engine

    cfg, params, reqs = _spec_engine_setup(cuda_dev)
    drafts = {}
    for eager in (True, False):
        eng = Engine(cfg, params, max_batch=2, capacity=96, prompt_buckets=[64],
                     prefill_chunk=7, device=cuda_dev, spec_tokens=4, draft="streaming",
                     eager=eager)
        for r in reqs[:2]:
            eng.submit(r)
        for _ in range(8):
            eng.poll()
        torch.cuda.synchronize()
        before = [t.clone() for _, _, t in graphs.snapshot(eng.batch.serve)]
        feeds = (eng._tok.clone(), eng._gen.clone())
        out = eng.draft.draft(eng, eng.batch.active.copy(), 4).clone()
        torch.cuda.synchronize()
        after = [t for _, _, t in graphs.snapshot(eng.batch.serve)]
        assert all(torch.equal(a, b) for a, b in zip(after, before))
        assert torch.equal(eng._tok, feeds[0]) and torch.equal(eng._gen, feeds[1])
        drafts[eager] = out[torch.from_numpy(eng.batch.active).to(cuda_dev)]
    assert torch.equal(drafts[True], drafts[False])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_pages_kernel_with_the_draft_selection(cuda_dev, dtype):
    """The streaming draft's retrieval decode: every selected slot the -1
    sentinel, so only the sink and local pages are attended, at the main
    path's shapes (138 slots of 32, 128 of them -1), against the plain
    version."""
    from repro_torch.core import paging

    b, hkv, g, d, p, c, ctx = 2, 4, 4, 128, 32, 258, 8193
    gen = torch.Generator(device=cuda_dev).manual_seed(21)
    sel = torch.full((b, hkv, 128), -1, dtype=torch.int32, device=cuda_dev)
    slots = paging.attended_page_slots(sel, ctx, sink=4, local=256, page=p).contiguous()
    first = torch.arange(c, device=cuda_dev) * p
    start = torch.where(first < ctx, first, -1).to(torch.int32).expand(b, hkv, c)
    valid = paging.token_validity(slots, start.contiguous(), ctx, sink=4, local=256,
                                  page=p, top_k=128).contiguous()
    q = _rand(gen, cuda_dev, dtype, b, hkv * g, d)
    kp = _rand(gen, cuda_dev, dtype, b, hkv, c, p, d)
    vp = _rand(gen, cuda_dev, dtype, b, hkv, c, p, d)
    got = ops.paged_attention_pages(q, kp, vp, slots, valid)
    want = tref.paged_attention_pages_ref(*_widened(q, kp, vp), slots, valid)
    torch.cuda.synchronize()
    # the selected section (slots 1..128) attends nothing; sink and local do
    assert not valid[..., p:129 * p].any() and bool(valid[..., :p].all())
    assert _within(got, want, dtype)


def _narrow_llama(seed):
    """Reduced llama3-8b with a small local window and select budget, so
    that most pages may be spilled (tests/test_torch_tiered.py's config),
    and its f32 weights on the CPU."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M

    cfg = reduced(get_arch("llama3-8b"))
    cfg = dataclasses.replace(cfg, h2eal=dataclasses.replace(cfg.h2eal, local=8,
                                                             select_budget=16))
    return cfg, M.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                              device="cpu")


def _requests(cfg, spec, seed):
    from repro_torch.serving.engine import Request

    rng = torch.Generator().manual_seed(seed)
    return [Request(uid=i, prompt=torch.randint(0, cfg.vocab_size, (n,),
                                                generator=rng).numpy(), max_new=m)
            for i, (n, m) in enumerate(spec)]


def _tier_stats(s):
    return {f: getattr(s, f) for f in ("tier_hits", "tier_misses", "tier_spills",
                                       "tier_fills", "tier_prefetch", "tier_archived",
                                       "tier_fill_batches", "tier_spill_batches",
                                       "tier_gather_batches")}


@pytest.mark.cuda
@pytest.mark.parametrize("layout,chunk", [("default", None), ("default", 8),
                                          ("coplace_shmap", 8)])
def test_tiered_engine_on_the_card_matches_the_cpu(cuda_dev, layout, chunk):
    """Tiered residency (hot_pages=6), captured, with one request forced cold
    at a selection boundary, on both layouts (co-placed over 4 stripes):
    the CPU engine's tokens and tier counters; the
    far store moved the bytes the counters say; the restore and the select
    step are captured once, at construction."""
    from repro_torch.core.cache import kv_page_tensors
    from repro_torch.serving.engine import Engine

    cfg, params = _narrow_llama(21)
    spec = [(64, 10), (40, 14), (64, 6), (56, 12)]
    kw = dict(max_batch=2, capacity=128, prompt_buckets=[40, 56, 64], hot_pages=6,
              prefill_chunk=chunk)
    if layout == "coplace_shmap":
        kw.update(layout=layout, shards=4)
    runs = {}
    for dev in ("cpu", cuda_dev):
        eng = Engine(cfg, _to(params, dev), device=dev, **kw)
        sizes = eng.jit_cache_sizes()
        for r in _requests(cfg, spec, 22):
            eng.submit(r)
        forced = 0
        while eng.busy():
            b = eng.batch
            if (not forced and eng.stats.decode_steps >= 4 and b.active[0]
                    and b.phase[0] % eng.share_window == 0 and b.remaining[0] > 2):
                forced = eng.tier_force_spill(int(b.uid[0]))
            eng.poll()
        eng.finalize()
        assert forced > 0 and eng.jit_cache_sizes() == sizes
        page = sum(t[0, :, 0].nbytes for t in kv_page_tensors(eng.batch.serve))
        s = eng.stats
        assert eng._tier.h2d_bytes == (s.tier_fills + s.tier_prefetch) * page
        assert eng._tier.d2h_bytes == s.tier_archived * page
        runs[str(dev)] = ({u: c.tokens for u, c in eng.completions.items()},
                          _tier_stats(s), sizes)
    (tok_c, st_c, _), (tok_g, st_g, sizes_g) = runs["cpu"], runs[str(cuda_dev)]
    assert tok_g == tok_c and st_g == st_c
    assert st_g["tier_misses"] == st_g["tier_fills"] > 0
    assert sizes_g["decode_select"] == sizes_g["tier_restore"] == 1


@pytest.mark.cuda
def test_rebalanced_engine_on_the_card_matches_the_cpu(cuda_dev):
    """retire-triggered migration on the card, captured: the CPU engine's
    tokens and rebalance counters, ``migrate`` captured once, and no poll
    synchronises with the card."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine

    cfg = reduced(get_arch("llama3-8b"))
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(23), device="cpu")
    spec = [(16, 12), (8, 3), (24, 18), (16, 5), (8, 16), (24, 4), (16, 9), (8, 7)]
    kw = dict(max_batch=4, capacity=64, prompt_buckets=[8, 16, 24], rebalance="retire",
              prefill_chunk=8)
    cpu = Engine(cfg, params, device="cpu", **kw)
    want = {u: c.tokens for u, c in cpu.run(_requests(cfg, spec, 24)).items()}
    eng = Engine(cfg, _to(params, cuda_dev), device=cuda_dev, **kw)
    sizes = eng.jit_cache_sizes()
    _serve_polled(eng, _requests(cfg, spec, 24))
    assert {u: c.tokens for u, c in eng.completions.items()} == want
    fields = ("rebalance_checks", "rebalances", "migrations", "migrated_tokens")
    assert [getattr(eng.stats, f) for f in fields] == [getattr(cpu.stats, f) for f in fields]
    assert eng.stats.migrations > 0
    assert sizes["migrate"] == 1 and eng.jit_cache_sizes() == sizes


@pytest.mark.cuda
def test_tier_fill_on_the_copy_stream_is_seen_by_the_next_replay(cuda_dev):
    """A page spilled (zeroed) and filled back on the tier's copy stream:
    a graph replayed on the current stream right after the fill reads the
    original rows, because the fill's event orders it first."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core import cache as cachelib
    from repro_torch.models import model as M

    cfg = reduced(get_arch("llama3-8b"))
    state = M.empty_serve_state(cfg, 2, capacity=4096, dtype=torch.bfloat16,
                                device=cuda_dev)
    gen = torch.Generator(device=cuda_dev).manual_seed(25)
    for t in cachelib.kv_page_tensors(state):
        t.copy_(torch.randn(t.shape, generator=gen, device=cuda_dev).to(t.dtype))
    pairs = [(s, p) for s in (0, 1) for p in range(3, 400, 7)]
    slots = torch.tensor([s for s, _ in pairs], device=cuda_dev)
    pages = torch.tensor([p for _, p in pairs], device=cuda_dev)
    original = cachelib.gather_kv_rows_pairs(state, slots, pages).clone()
    tier = cachelib.TieredPagedCache(n_slots=2, n_pages=4096 // 8, hot_pages=4,
                                     page_size=8, sink=2, local=16, device=cuda_dev)
    read = torch.empty_like(original)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(cuda_dev)
    side.wait_stream(torch.cuda.current_stream(cuda_dev))
    with torch.cuda.stream(side):
        read.copy_(cachelib.gather_kv_rows_pairs(state, slots, pages))
    torch.cuda.current_stream(cuda_dev).wait_stream(side)
    with torch.cuda.graph(graph):
        read.copy_(cachelib.gather_kv_rows_pairs(state, slots, pages))
    for _ in range(3):
        assert tier.archive(state, pairs) in (len(pairs), 0)
        tier.spill(state, pairs)
        graph.replay()
        torch.cuda.synchronize()
        assert not read.any()            # the spill was seen: zero rows
        tier.fill(state, pairs)
        graph.replay()                   # no synchronisation in between
        torch.cuda.synchronize()
        assert torch.equal(read, original)
    assert tier.h2d_bytes == 3 * original.nbytes and tier.d2h_bytes == original.nbytes


@pytest.mark.cuda
def test_moe_ffn_on_the_card_matches_the_cpu(cuda_dev):
    """qwen3-moe's MoE layer (reduced: 4 experts, top-2) at capacity factor
    0.25 over 64 tokens, where experts overflow and slot cap-1 of each
    overflowing expert returns 0 as the reference's last write leaves it:
    the card against the CPU on the same f32 weights; two card calls, and a
    CUDA graph replay of the call, equal bit for bit (the dispatch has no
    scatter with repeated indices and the combine no atomics)."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import moe

    cfg = reduced(get_arch("qwen3-moe-235b-a22b"), num_heads=32, num_kv_heads=2)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, dtype=torch.float32,
                     device="cpu")
    x = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(1))
    _, _, ids = moe._route(cfg, p, x)
    cap = moe._capacity(64, cfg.moe.num_experts, cfg.moe.top_k, 0.25)
    assert int(torch.bincount(ids.reshape(-1)).max()) > cap
    want = moe.moe_ffn(cfg, p, x)
    pc = _to(p, cuda_dev)
    xc = x.to(cuda_dev)
    got = moe.moe_ffn(cfg, pc, xc)
    again = moe.moe_ffn(cfg, pc, xc)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe.moe_ffn(cfg, pc, xc)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = moe.moe_ffn(cfg, pc, xc)
    graph.replay()
    torch.cuda.synchronize()
    assert (got.cpu() - want).abs().max().item() <= 1e-4
    assert torch.equal(got, again) and torch.equal(got, captured)


def _recurrent_cfg(kind):
    from repro_torch.configs import get_arch, reduced

    if kind == "mamba2":  # the reference's hybrid: mamba2, mamba2, attention
        return reduced(get_arch("zamba2-2.7b"), mixer_pattern=("mamba2", "mamba2", "attention"),
                       num_layers=3)
    return reduced(get_arch("xlstm-125m"))  # mlstm, mlstm, slstm, mlstm


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mamba2", "xlstm"])
def test_captured_recurrent_chunk_step_matches_eager(cuda_dev, kind):
    """The engine's chunk step on a recurrent stack (f32, 3 slots, chunks of
    8 with a ragged tail and a slot without tokens), captured as a CUDA
    graph after a warm-up with every input zero, against the same step run
    eagerly on a copy of the state: the logits and every state tensor (the
    recurrent states written in place, the KV caches) equal bit for bit,
    and the slot without tokens keeps its rows."""
    import copy

    from repro_torch.models import model as M
    from repro_torch.runtime import graphs
    from repro_torch.runtime import serve as serve_rt

    cfg = _recurrent_cfg(kind)
    params = _to(M.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu"),
                 cuda_dev)
    cap, c = 64, 8
    step = serve_rt.make_prefill_chunk_step(cfg, serve_rt.ServeConfig(capacity=cap), chunk=c)
    gen = torch.Generator().manual_seed(1)
    toks = [torch.randint(0, cfg.vocab_size, (3, c), generator=gen).to(torch.int32).to(cuda_dev)
            for _ in range(2)]
    first = torch.tensor([8, 8, 5], dtype=torch.int32, device=cuda_dev)
    second = torch.tensor([8, 3, 0], dtype=torch.int32, device=cuda_dev)
    state = M.empty_serve_state(cfg, 3, capacity=cap, dtype=torch.float32, device=cuda_dev)
    before = graphs.snapshot(state)  # some state to resume from
    graphs.commit(before, step(params, state, toks[0], first, first > 0)[1])
    eager = copy.deepcopy(state)

    g = graphs.StepGraphs(cuda_dev)
    ctoks = g.input("ctoks", (3, c), torch.int32)
    clens = g.input("clens", (3,), torch.int32)

    def chunk():
        before = graphs.snapshot(state)
        logits, new = step(params, state, ctoks, clens, clens > 0)
        graphs.commit(before, new)
        return logits
    g.add("chunk", chunk)
    assert g.captures == {"chunk": 1}
    ctoks.copy_(toks[1])
    clens.copy_(second)
    got = g.run("chunk").clone()
    want, eager_new = step(params, eager, toks[1], second, second > 0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for (_, key, a), (_, _, b) in zip(graphs.snapshot(state), graphs.snapshot(eager_new)):
        assert torch.equal(a, b), key
    pre = copy.deepcopy(state)
    g.run("chunk")  # slot 2 takes no tokens: its rows stay as they are
    for (_, key, a), (_, _, b) in zip(graphs.snapshot(state), graphs.snapshot(pre)):
        if key != "length":
            assert torch.equal(a[2], b[2]), key
