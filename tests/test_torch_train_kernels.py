"""The training kernels' plain PyTorch versions against the JAX functions, on
the CPU in f32, inputs from a numpy seed handed to both sides: ``int4_matmul_t``
and ``int4_qlinear`` (against the Pallas kernels in interpret mode and the
dequantise-then-einsum reference), the flash attention's forward (against the
Pallas kernel in interpret mode and JAX's dense ``causal_attention``) and its
closed-form backward (against ``jax.grad`` of the dense attention and against
autograd through the plain forward), the padding mask, the numerics the bf16
tensor-core kernels are allowed (p and ds rounded to bf16, emulated here), what
the wrappers refuse, and ``ops/attention.causal_attention`` with its rotation. The CUDA kernels are held
against these plain versions on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.ops import attention as jattn
from aha_tpu.ops.pallas import flash_attention as jflash
from aha_tpu.ops.pallas.fused_matmul import int4_matmul_t as j_int4_matmul_t
from aha_tpu.ops.pallas.fused_matmul import int4_qlinear as j_int4_qlinear
from aha_tpu.ops.quant import dequantize_int4, quantize_array_int4
from aha_tpu.ops.rope import apply_rope as j_apply_rope
from aha_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin

from aha_tpu_torch import bridge
from aha_tpu_torch.ops import attention as tattn
from aha_tpu_torch.ops import quant as tquant
from aha_tpu_torch.ops.kernels import flash_attention as fa
from aha_tpu_torch.ops.kernels.int4_matmul import int4_qlinear
from aha_tpu_torch.ops.kernels.int4_matmul_t import int4_matmul_t, int4_matmul_t_plain
from aha_tpu_torch.ops.rope import apply_rope


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return bridge.tensor_from_numpy(np.asarray(x))


# -- int4_matmul_t, int4_qlinear ------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    K, N = 512, 256
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((3, 7, K)).astype(np.float32)   # ragged M = 21
    return x, w


@pytest.mark.parametrize("group", [128, 256])
def test_int4_matmul_t_plain(data, group):
    """3e-5: f32 sums in another order than the Pallas kernel's blocks."""
    _, w = data
    K, N = w.shape
    q4 = quantize_array_int4(jnp.asarray(w), 0, group=group)
    g = np.random.default_rng(3).standard_normal((3, 7, N)).astype(np.float32)
    ref = jnp.einsum("...n,kn->...k", g, dequantize_int4(q4, jnp.float32))
    pallas = j_int4_matmul_t(jnp.asarray(g), q4["q4value"], q4["scale4"], block_n=128,
                             block_k=256, interpret=True)
    q, s = _t(q4["q4value"]), _t(q4["scale4"])
    out = int4_matmul_t_plain(_t(g), q, s)
    assert out.shape == (3, 7, K) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-5, atol=3e-5)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(int4_matmul_t(_t(g), q, s), out)


def test_int4_qlinear_grad(data):
    """2e-4, as the TPU package holds its custom VJP to the dequant path."""
    x, w = data
    q4 = quantize_array_int4(jnp.asarray(w), 0)
    tgt = np.random.default_rng(4).standard_normal((*x.shape[:-1], w.shape[1])).astype(np.float32)
    ref = jax.grad(lambda x_: jnp.sum(
        (j_int4_qlinear(x_, q4["q4value"], q4["scale4"], None) - tgt) ** 2))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    y = int4_qlinear(xt, _t(q4["q4value"]), _t(q4["scale4"]))
    ((y - _t(tgt)) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("layer", [0, 1])
def test_int4_qlinear_grad_stacked_layer(data, layer):
    """A stacked [L, K/2, N] weight: the port passes the views of layer l, JAX
    the stack and a traced index; the gradient must come through that layer."""
    x, w = data
    K, N = w.shape
    ws = (np.random.default_rng(5).standard_normal((2, K, N)) * 0.02).astype(np.float32)
    q4 = quantize_array_int4(jnp.asarray(ws), 1)
    ref = jax.grad(lambda x_: jnp.sum(j_int4_qlinear(
        x_, q4["q4value"], q4["scale4"], jnp.int32(layer)) ** 2))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    kernel = {"q4value": _t(q4["q4value"])[layer], "scale4": _t(q4["scale4"])[layer]}
    (tquant.qlinear(xt, kernel) ** 2).sum().backward()      # the model's route to int4_qlinear
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-4)


def test_qlinear_under_grad_refuses_what_has_no_gradient(data):
    x, w = data
    q4 = quantize_array_int4(jnp.asarray(w), 0)
    k4 = {"q4value": _t(q4["q4value"]), "scale4": _t(q4["scale4"])}
    k8 = {"qvalue": torch.zeros(w.shape, dtype=torch.int8), "scale": torch.ones(1, w.shape[1])}
    xt = _t(x).requires_grad_()
    # int8 weights carry a gradient since int8_qlinear; the other backends have none
    assert tquant.qlinear(xt, k8).grad_fn is not None
    with pytest.raises(ValueError, match="pallas"):
        tquant.qlinear(xt, k8, backend="pallas")
    with pytest.raises(ValueError, match="fused_a8"):
        tquant.qlinear(xt, k4, backend="fused_a8")
    # no gradient to carry: the inference wrappers, no autograd node
    with torch.no_grad():
        assert tquant.qlinear(xt, k8).shape == (3, 7, w.shape[1])
    y = tquant.qlinear(xt.detach(), k4)
    assert not y.requires_grad and y.grad_fn is None
    assert tquant.qlinear(xt, k4).grad_fn is not None


# -- flash attention ----------------------------------------------------------------


def _qkv(seed, B, T, NH, KVH, Dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, T, h, Dh)).astype(np.float32) for h in (NH, KVH, KVH))


def _jax_dense(q, k, v, attn_mask=None):
    """JAX's dense causal attention on ALREADY rotated operands: positions 0
    make its rotation the identity."""
    B, T = q.shape[:2]
    return jattn.causal_attention(q, k, v, rope_theta=1e6,
                                  positions=jnp.zeros((B, T), jnp.int32), attn_mask=attn_mask)


GQA = [pytest.param(8, 2, id="gqa4"), pytest.param(14, 2, id="gqa7")]


@pytest.mark.parametrize("NH,KVH", GQA)
def test_flash_forward_plain(NH, KVH):
    """1e-4 against the Pallas kernel (interpret mode, blocks of 32) and the
    dense reference; T = 45 is no multiple of 32."""
    q, k, v = _qkv(1, 2, 45, NH, KVH, 16)
    o, lse = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v))
    pallas = jflash.flash_causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           block_q=32, block_k=32, interpret=True)
    dense = _jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(o.numpy(), np.asarray(pallas), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(o.numpy(), np.asarray(dense), rtol=1e-4, atol=1e-4)
    # the log-sum-exp of the scaled causal scores, [B, NH, T]
    s = np.einsum("bshd,bthd->bhst", q, np.repeat(k, NH // KVH, axis=2)) / 4.0
    s = np.where(np.tril(np.ones((45, 45), bool)), s, -np.inf)
    ref_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    assert lse.shape == (2, NH, 45)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=1e-4, atol=1e-4)
    assert torch.equal(fa.flash_causal_attention(_t(q), _t(k), _t(v)), o)


@pytest.mark.parametrize("NH,KVH", GQA)
def test_flash_backward_plain(NH, KVH):
    """The closed-form backward against jax.grad of the dense attention and
    against autograd through the plain forward (1e-4), and the Function's
    gradients (which are that backward on the CPU)."""
    q, k, v = _qkv(2, 2, 37, NH, KVH, 16)
    dout = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    ref = jax.grad(lambda *a: jnp.sum(_jax_dense(*a) * dout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    o, lse = fa.flash_attention_fwd_plain(qt, kt, vt)
    auto = torch.autograd.grad(o, (qt, kt, vt), _t(dout))
    closed = fa.flash_causal_attention_bwd_plain(qt.detach(), kt.detach(), vt.detach(),
                                                 o.detach(), _t(dout), lse.detach())
    via_function = torch.autograd.grad(fa.flash_causal_attention(qt, kt, vt), (qt, kt, vt),
                                       _t(dout))
    for name, c, a, f, r in zip("qkv", closed, auto, via_function, ref):
        np.testing.assert_allclose(c.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name} vs jax.grad")
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name} vs autograd")
        assert torch.equal(f, c), f"d{name} through the Function"


def test_flash_key_valid_rows():
    """A left-padded batch: padded keys are seen by no query; a padded query
    sees nothing and gives 0 with lse -inf (JAX's dense branch gives it the
    mean of all values instead, so only the real rows are compared); the
    gradients of a loss over the real rows agree with jax.grad."""
    B, T, NH, KVH, Dh = 3, 41, 8, 2, 16
    q, k, v = _qkv(4, B, T, NH, KVH, Dh)
    pad = np.array([0, 9, 40])
    valid = np.arange(T)[None] >= pad[:, None]
    dout = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    dout = dout * valid[:, :, None, None]                   # the loss reads real rows only
    dense = lambda *a: _jax_dense(*a, attn_mask=jnp.asarray(valid))
    ref = np.asarray(dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    ref_grads = jax.grad(lambda *a: jnp.sum(dense(*a) * dout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    o = fa.flash_causal_attention(qt, kt, vt, _t(valid))
    _, lse = fa.flash_attention_fwd_plain(qt.detach(), kt.detach(), vt.detach(), _t(valid))
    np.testing.assert_allclose(o.detach().numpy()[valid], ref[valid], rtol=1e-4, atol=1e-4)
    assert o.detach().numpy()[~valid].max() == 0.0 == o.detach().numpy()[~valid].min()
    assert np.isneginf(lse.numpy().transpose(0, 2, 1)[~valid]).all()
    assert np.isfinite(lse.numpy().transpose(0, 2, 1)[valid]).all()
    grads = torch.autograd.grad(o, (qt, kt, vt), _t(dout))
    for name, g, r in zip("qkv", grads, ref_grads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4,
                                   err_msg=f"d{name}")
    # nothing flows into a padded key or value, or out of a padded query
    assert grads[0].numpy()[~valid].max() == 0.0 and grads[1].numpy()[~valid].max() == 0.0
    assert grads[2].numpy()[~valid].max() == 0.0


def _bf16(x):
    """f32 values that bf16 holds exactly (round to nearest even, as the card stores them)."""
    return _t(x).to(torch.bfloat16).float()


def _tensor_core_emulation(q, k, v, dout, valid):
    """What the bf16 kernels compute, in plain PyTorch: products of bf16 values
    summed in f32, the forward over tiles of 64 keys with a running maximum in
    units of log 2 and p rounded to bf16 before p @ v (the row sum keeps the
    unrounded p), the backward with p and ds rounded to bf16 before dv = p^T do,
    dq = ds k and dk = ds^T q. -> (o, lse, dq, dk, dv), o and the gradients
    rounded to bf16 as they are stored."""
    B, T, NH, Dh = q.shape
    KVH = k.shape[2]
    rnd = lambda x: x.to(torch.bfloat16).float()
    grouped = lambda x: x.reshape(B, T, KVH, NH // KVH, Dh)
    scale = 1.0 / np.sqrt(Dh)
    s = torch.einsum("bsgrd,btgd->bgrst", grouped(q), k)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool))[None, None, None]
    if valid is not None:
        mask = mask & valid[:, None, None, None, :]
    s2 = (s * (scale * np.log2(np.e))).masked_fill(~mask, float("-inf"))
    m = torch.full(s2.shape[:-1], float("-inf"))
    l = torch.zeros(s2.shape[:-1])
    acc = torch.zeros((B, KVH, NH // KVH, T, Dh))
    for k0 in range(0, T, 64):
        tile = s2[..., k0:k0 + 64]
        m_new = torch.maximum(m, tile.max(-1).values)
        m_use = torch.nan_to_num(m_new, neginf=0.0)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(tile - m_use[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrst,btgd->bgrsd", rnd(p), v[:, k0:k0 + 64])
        m = m_new
    o = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
    o = rnd(o.permute(0, 3, 1, 2, 4).reshape(B, T, NH, Dh))
    lse = torch.where(l > 0, m * np.log(2.0) + torch.log(l), float("-inf")).reshape(B, NH, T)

    p = torch.where(mask, torch.exp2(s2 - (torch.nan_to_num(lse, neginf=0.0) * np.log2(np.e))
                                     .reshape(B, KVH, NH // KVH, T, 1)), 0.0)
    dog = grouped(dout)
    delta = (dog * grouped(o)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (torch.einsum("bsgrd,btgd->bgrst", dog, v) - delta[..., None])
    dq = torch.einsum("bgrst,btgd->bsgrd", rnd(ds), k).reshape(B, T, NH, Dh) * scale
    dk = torch.einsum("bgrst,bsgrd->btgd", rnd(ds), grouped(q)) * scale
    dv = torch.einsum("bgrst,bsgrd->btgd", rnd(p), dog)
    return o, lse, rnd(dq), rnd(dk), rnd(dv)


@pytest.mark.parametrize("pad", [None, (0, 21)], ids=["dense", "key_valid"])
def test_flash_bf16_tensor_core_numerics(pad):
    """The rounding the bf16 kernels are allowed (p and ds in bf16, f32 sums)
    stays inside the tolerance the kernels are held to on the card: 1e-2 of
    the largest |o| forward, 2e-2 of the largest |gradient| backward, against
    JAX's dense attention and jax.grad of it in f32 on the same bf16 values.
    GQA 7:1, Dh 128, T = 150 (two full tiles of 64 keys and a ragged third);
    a padded query is compared nowhere (JAX gives it the mean of all values)."""
    B, T, NH, KVH, Dh = 2, 150, 14, 2, 128
    q, k, v = (_bf16(a) for a in _qkv(11, B, T, NH, KVH, Dh))
    valid = None if pad is None else np.arange(T)[None] >= np.array(pad)[:, None]
    real = np.ones((B, T), bool) if valid is None else valid
    dout = _bf16(np.random.default_rng(12).standard_normal(q.shape).astype(np.float32)
                 * real[:, :, None, None])
    dense = lambda *a: _jax_dense(*a, attn_mask=None if valid is None else jnp.asarray(valid))
    jq, jk, jv = (jnp.asarray(a.numpy()) for a in (q, k, v))
    ref = np.asarray(dense(jq, jk, jv))
    ref_grads = jax.grad(lambda *a: jnp.sum(dense(*a) * dout.numpy()), argnums=(0, 1, 2))(
        jq, jk, jv)
    o, lse, *grads = _tensor_core_emulation(q, k, v, dout, None if valid is None else _t(valid))
    assert np.abs(o.numpy() - ref)[real].max() <= 1e-2 * np.abs(ref[real]).max()
    for name, g, r in zip("qkv", grads, ref_grads):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 2e-2 * np.abs(r).max(), f"d{name}"
    # the emulation's lse is the plain version's: the backward recomputes p from either
    _, lse_plain = fa.flash_attention_fwd_plain(q, k, v, None if valid is None else _t(valid))
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_plain))
    np.testing.assert_allclose(torch.nan_to_num(lse, neginf=0.0).numpy(),
                               torch.nan_to_num(lse_plain, neginf=0.0).numpy(), atol=1e-4)
    if valid is not None:
        assert o.numpy()[~valid].max() == 0.0 == o.numpy()[~valid].min()
        assert np.isneginf(lse.numpy().transpose(0, 2, 1)[~valid]).all()


@pytest.mark.parametrize("what,match", [
    ("head_dim", "head_dim 64 not supported"),
    ("strided", "q must be contiguous"),
    ("key_valid", "key_valid must be a contiguous bool"),
    ("device", "unsupported device cpu"),
])
def test_flash_wrapper_refuses(what, match):
    """What the kernels do not take raises in the wrapper's check, whatever
    the device; a well-formed CPU input is refused only for its device (the
    wrappers send a CPU tensor to the plain version before the check)."""
    B, T, NH, KVH = 2, 9, 4, 2
    Dh = 64 if what == "head_dim" else 16
    q, k, v = (_t(a) for a in _qkv(13, B, T, NH, KVH, Dh))
    valid = torch.ones((B, T), dtype=torch.bool)
    if what == "strided":
        q = torch.cat([q, q], dim=-1)[..., :Dh]
    if what == "key_valid":
        valid = valid[:, :-1]
    with pytest.raises(ValueError, match=match):
        fa._check("flash_attention_fwd", q, k, v, valid)


@pytest.mark.parametrize("T", [33, 70])
def test_flash_blockwise_agreement(T):
    """Against JAX's blockwise branch, whose guard also gives a query without
    a visible key 0: a padded batch agrees on EVERY row (T padded to the
    block on the JAX side, as its callers do)."""
    B, NH, KVH, Dh = 2, 4, 2, 16
    q, k, v = _qkv(6, B, T, NH, KVH, Dh)
    valid = np.arange(T)[None] >= np.array([0, 7])[:, None]
    Tp = -(-T // 32) * 32
    padded = [jnp.pad(jnp.asarray(a), ((0, 0), (0, Tp - T), (0, 0), (0, 0))) for a in (q, k, v)]
    ref = jattn.blockwise_causal_attention(
        *padded, attn_mask=jnp.pad(jnp.asarray(valid), ((0, 0), (0, Tp - T))), block_size=32)
    o = fa.flash_causal_attention_plain(_t(q), _t(k), _t(v), _t(valid))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref)[:, :T], rtol=1e-4, atol=1e-4)


def test_causal_attention_rotates_then_attends():
    """``ops/attention.causal_attention`` (unrotated operands, positions or
    tables) against JAX's, forward and gradients, 1e-4."""
    B, T, NH, KVH, Dh = 2, 29, 4, 2, 16
    q, k, v = _qkv(7, B, T, NH, KVH, Dh)
    pos = np.stack([np.arange(T), np.arange(T) + 3]).astype(np.int32)
    dout = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    f = lambda *a: jattn.causal_attention(*a, rope_theta=1e4, positions=jnp.asarray(pos))
    ref = f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = jax.grad(lambda *a: jnp.sum(f(*a) * dout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = tattn.causal_attention(qt, kt, vt, rope_theta=1e4, positions=_t(pos))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    for g, r in zip(torch.autograd.grad(out, (qt, kt, vt), _t(dout)), ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)
    # tables in place of positions, and the default positions 0..T-1
    cos, sin = j_rope_cos_sin(jnp.asarray(pos), Dh, 1e4)
    with torch.no_grad():
        tabled = tattn.causal_attention(qt, kt, vt, rope_theta=1e4,
                                        rope_tables=(_t(cos), _t(sin)))
        default = tattn.causal_attention(qt[:1], kt[:1], vt[:1], rope_theta=1e4)
    np.testing.assert_allclose(tabled.numpy(), out.detach().numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(default.numpy(), out.detach().numpy()[:1], rtol=1e-6, atol=1e-6)
    # the rotation itself, for the record of where a difference would come from
    rot = j_apply_rope(jnp.asarray(q), cos, sin)
    np.testing.assert_allclose(apply_rope(_t(q), _t(cos), _t(sin)).numpy(), np.asarray(rot),
                               rtol=1e-6, atol=1e-6)
