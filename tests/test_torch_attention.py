"""svpc_torch.ops.attention against the JAX package's attention.

On the CPU the port's ``fused_attention`` runs ``attention_plain``; both
are held against the JAX Pallas ``fused_attention`` in interpret mode (the
TPU kernel the CUDA kernel replaces) at rtol = atol = 2e-5, on the cases of
tests/test_pallas.py and on the serving path's forms at small width.  The
CUDA kernel itself is compared with the plain version where a card is
present (and by chip_smoke.py on the card)."""

import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, n, lq, lk, h):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, lq, h).astype(np.float32),
            rng.randn(n, lk, h).astype(np.float32),
            rng.randn(n, lk, h).astype(np.float32), rng)


def _key_padding(seed=0, n=4, l=20, h=32):
    q, k, v, rng = _inputs(seed, n, l, l, h)
    return q, k, v, (rng.rand(n, 1, l) > 0.3).astype(np.float32), {}


def _multiblock(seed=1, n=2, l=300, h=32):
    q, k, v, rng = _inputs(seed, n, l, l, h)
    return (q, k, v, (rng.rand(n, 1, l) > 0.3).astype(np.float32),
            dict(block_q=128, block_k=128))


def _causal(seed=2, n=2, l=160, h=32):
    q, k, v, rng = _inputs(seed, n, l, l, h)
    pad = (rng.rand(n, 1, l) > 0.2).astype(np.float32)
    pad[:, :, 0] = 1.0  # every causal row keeps a visible key
    mask = pad * np.tril(np.ones((l, l), np.float32))[None]
    return q, k, v, mask, dict(block_q=64, block_k=128)


def _cached_self(seed=3, n=6, t=8, h=32):
    """Decoder cached self-attention: Lq=1 against a (N, T) cache of which
    positions <= 4 are filled."""
    q, k, v, _ = _inputs(seed, n, 1, t, h)
    mask = np.broadcast_to((np.arange(t) <= 4).astype(np.float32),
                           (n, 1, t)).copy()
    return q, k, v, mask, {}


def _cross(seed=4, n=6, m=3, h=32):
    """Decoder cached cross-attention over M=3 memory slots, all visible."""
    q, k, v, _ = _inputs(seed, n, 1, m, h)
    return q, k, v, np.ones((n, 1, m), np.float32), {}


def _full_causal_decoder(seed=5, n=6, t=8, h=32):
    """The use_cache=False decoder: full (N, T, T) causal x text mask."""
    q, k, v, _ = _inputs(seed, n, t, t, h)
    text = np.zeros((n, t), np.float32)
    text[:, :5] = 1.0
    mask = text[:, None, :] * np.tril(np.ones((t, t), np.float32))[None]
    return q, k, v, mask, {}


CASES = {"key_padding": _key_padding, "multiblock": _multiblock,
         "causal": _causal, "cached_self": _cached_self, "cross": _cross,
         "full_causal_decoder": _full_causal_decoder}


def test_port_matches_jax_attention():
    """Every case against the Pallas kernel in interpret mode; then rows
    with every key masked (padded video slots / padded packed clips in
    serving) against JAX attention_core, which the Pallas kernel differs
    from there by design (its padded keys join the softmax)."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from svpc_tpu.model.layers import attention_core
    from svpc_tpu.ops import pallas_attention
    from svpc_torch.ops.attention import attention_plain, fused_attention

    nh = 4
    for case in sorted(CASES):
        q, k, v, mask, blocks = CASES[case]()
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(pallas_attention.fused_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(mask), nh, **blocks))
        tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
        np.testing.assert_allclose(fused_attention(tq, tk, tv, tm, nh),
                                   want, err_msg=case, **TOL)
        np.testing.assert_allclose(attention_plain(tq, tk, tv, tm, nh),
                                   want, err_msg=case, **TOL)

    q, k, v, rng = _inputs(6, 3, 12, 12, 32)
    mask = (rng.rand(3, 1, 12) > 0.3).astype(np.float32)
    mask[1] = 0.0  # sequence 1 sees no key at all
    want = np.asarray(jax.jit(functools.partial(
        attention_core, num_heads=nh, dropout_rate=0.0,
        deterministic=True))(q, k, v, mask))
    got = fused_attention(*map(torch.from_numpy, (q, k, v, mask)), nh)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    from svpc_torch.ops.attention import _check

    q = torch.zeros(2, 5, 32)
    k = torch.zeros(2, 7, 32)
    with pytest.raises(ValueError, match="mask"):
        _check(q, k, k, torch.ones(2, 3, 7), 4)
    with pytest.raises(ValueError, match="head width"):
        _check(torch.zeros(2, 5, 260), torch.zeros(2, 7, 260),
               torch.zeros(2, 7, 260), torch.ones(2, 1, 7), 2)
    with pytest.raises(TypeError, match="float32 or"):
        _check(q.double(), k.double(), k.double(), torch.ones(2, 1, 7), 4)
    with pytest.raises(ValueError, match="contiguous"):
        _check(torch.zeros(2, 32, 5).transpose(1, 2), k, k,
               torch.ones(2, 1, 7), 4)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, on the low 13 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the tile path forms it in f32: x = big + small, the two
    cross terms and then big.big, each product exact, sums in f32."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def test_kernel_arithmetic_and_plan():
    """On the CPU: the tile path's 3xTF32 arithmetic holds 1e-5 against
    float64 at the serving widths (dh=64; Lq=Lk=100 and Lq=1, Lk=22) and
    a single TF32 product does not; ``_plan`` picks the path and geometry
    the kernel is written for; misaligned tensors are refused."""
    from svpc_torch.ops.attention import DECODE_MAX_LQ, Plan, \
        _check_alignment, _plan

    rng = np.random.RandomState(7)
    for lq, lk in ((100, 100), (1, 22)):
        q, k, v = (torch.from_numpy(rng.randn(4, length, 64)
                                    .astype(np.float32))
                   for length in (lq, lk, lk))
        add = torch.from_numpy(
            (rng.rand(4, 1, lk) > 0.3).astype(np.float32) - 1.0) * 1e4
        want = torch.softmax(q.double() @ k.double().transpose(1, 2) / 8.0
                             + add.double(), -1) @ v.double()
        p3 = torch.softmax(_mm_3xtf32(q, k.transpose(1, 2)) * 0.125 + add,
                           -1)
        err3 = (_mm_3xtf32(p3, v).double() - want).abs().max().item()
        p1 = torch.softmax(_tf32(q) @ _tf32(k).transpose(1, 2) * 0.125
                           + add, -1)
        err1 = (_tf32(p1) @ _tf32(v)).double().sub(want).abs().max().item()
        assert err3 <= 1e-5, (lq, lk, err3)
        assert err1 > 1e-5, (lq, lk, err1)  # why the split is needed

    f32 = torch.float32
    assert _plan(96, 100, 12, 64, f32) == Plan("tile", (1, 12, 96),
                                               (256, 1, 1), 7)
    assert _plan(8, 12, 12, 64, f32) == Plan("tile", (1, 12, 8),
                                             (64, 1, 1), 1)
    assert _plan(8, 300, 12, 64, f32) == Plan("tile", (3, 12, 8),
                                              (256, 1, 1), 7)
    assert _plan(96, 1, 12, 64, f32) == Plan("decode", (576, 1, 1),
                                             (64, 1, 1), 2)
    assert _plan(96, DECODE_MAX_LQ, 12, 64, f32).path == "decode"
    assert _plan(96, DECODE_MAX_LQ + 1, 12, 64, f32).path == "tile"
    # a bf16 row of 12 columns is no whole number of 16-byte units
    assert _plan(2, 100, 4, 12, torch.bfloat16).path == "decode"
    assert _plan(2, 100, 4, 16, torch.bfloat16).path == "tile"
    # f32 rows wider than 64: 64-row blocks, so that a full mask's terms
    # fit the shared memory of a block
    assert _plan(96, 100, 6, 128, f32) == Plan("tile", (2, 6, 96),
                                               (160, 1, 1), 4)
    assert _plan(96, 100, 6, 128, torch.bfloat16) == Plan(
        "tile", (1, 6, 96), (256, 1, 1), 7)

    x = torch.zeros(2, 5, 36)
    _check_alignment(x[..., :32], x[..., :32], x[..., :32])  # 144 B rows
    with pytest.raises(ValueError, match="16-byte"):
        _check_alignment(x[..., 1:], x[..., :32], x[..., :32])
    with pytest.raises(ValueError, match="16-byte"):
        y = torch.zeros(2, 5, 34)[..., :32]
        _check_alignment(x[..., :32], y, x[..., :32])


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The hand-written kernel against attention_plain on the card, at the
    serving path's forms, a long key axis, both sides of the path
    threshold, the widest head (dh=128) on both paths, a bf16 head
    of 12 columns at Lq=100 (the decode path), and on a sequence that sees
    no key at all; both paths run.

    Run on the card with
    ``python -m pytest --noconftest -m cuda tests/test_torch_attention.py``
    (the card's machine has no JAX, which tests/conftest.py imports)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs this check)")
    from svpc_torch.ops.attention import DECODE_MAX_LQ, LAUNCHES, _plan, \
        attention_plain, fused_attention, reset_launches

    reset_launches()
    gen = torch.Generator().manual_seed(0)
    for (dtype, tol), (n, lq, lk, full, none_visible, nh) in \
            itertools.product(
                ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)),
                ((96, 100, 100, False, False, 12),
                 (8, 12, 12, False, False, 12),
                 (96, 1, 22, False, False, 12), (96, 1, 3, False, False, 12),
                 (96, 22, 22, True, False, 12),
                 (96, 100, 100, False, True, 12),
                 (8, 300, 300, False, False, 12),
                 (96, DECODE_MAX_LQ, 22, True, False, 12),
                 (96, DECODE_MAX_LQ + 1, 22, True, False, 12),
                 (96, 100, 100, False, False, 6),
                 (96, 100, 100, True, False, 6), (96, 1, 22, False, False, 6),
                 (8, 100, 100, True, False, 64))):
        q, k, v = (torch.randn(n, l, 768, generator=gen).to("cuda", dtype)
                   for l in (lq, lk, lk))
        mask = (torch.rand(n, lq if full else 1, lk, generator=gen) > 0.3)
        mask = mask.float()
        mask[..., 0] = 1.0
        if full:
            mask = mask * torch.tril(torch.ones(lq, lk))
        row_tol = tol
        if none_visible:
            # every score at -1e4 + O(1), on the f32 grid of 2**-10: each
            # probability may differ by a factor exp(+-2**-10)
            mask[0] = 0.0
            row_tol = max(tol, 2e-3 * v.float().abs().max().item())
        mask = mask.cuda()
        path = "fused_attention." + _plan(n, lq, nh, 768 // nh, dtype).path
        before, before_path = LAUNCHES["fused_attention"], LAUNCHES[path]
        got = fused_attention(q, k, v, mask, nh)
        torch.cuda.synchronize()
        assert LAUNCHES["fused_attention"] == before + 1
        assert LAUNCHES[path] == before_path + 1
        want = attention_plain(q, k, v, mask, nh)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= row_tol, (n, lq, lk, nh, dtype, err)
    assert LAUNCHES["fused_attention.tile"] > 0
    assert LAUNCHES["fused_attention.decode"] > 0
