"""The read-only verify pass of the port against JAX and against itself, on
the CPU in f32: every function of ``ops/spec_decode.py`` (plan_compose,
build_draft_hist, ngram_draft, select_meta, commit_slots),
``speculative_attention`` and ``decode_chunk_spec``, on the scenarios of
tests/test_spec_decode.py (policies none / sliding / sink / static, prefill
through the window fill, ragged rows, int8 KV).

Two properties are held: the port equals the JAX function on the same numpy
inputs (1e-5: f32 sums in another order), and the port's verify pass equals
the port's own S sequential 1-token ``decode_chunk`` steps, with the
committed cache equal to the sequentially written one (2e-5, the bound the
JAX tests hold their own pass to). The replayed attention of the verify pass
``generate_spec`` and fused scoring run (``replayed_attention``) is held to
more: the sequential steps' attention bit for bit, with the cache only read."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.config import qwen2_tiny
from aha_tpu.models import qwen2 as jqwen2
from aha_tpu.ops import attention as jattn
from aha_tpu.ops import kv_cache as jkv
from aha_tpu.ops import spec_decode as jspec

from aha_tpu_torch import config as tconfig
from aha_tpu_torch import bridge
from aha_tpu_torch.models import qwen2 as tqwen2
from aha_tpu_torch.ops import attention as tattn
from aha_tpu_torch.ops import kv_cache as tkv
from aha_tpu_torch.ops import spec_decode as tspec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the bridge puts a tree on the card unless told otherwise; these tests run on the host
params_from_jax = functools.partial(bridge.params_from_jax, device="cpu")
S = 4
B = 2
ATOL = 1e-5
PLAN_FIELDS = ("slots", "g", "q_pos", "write_pos", "valid", "cache_mask", "infl_mask",
               "meta_order", "meta_seen", "meta_length", "qx", "dpos", "exact")


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _policies(kind):
    kw = {"sink": dict(window=32, num_sink=4), "none": dict(window=512)}.get(
        kind, dict(window=32))
    return jkv.CachePolicy(kind, **kw), tkv.CachePolicy(kind, **kw)


@pytest.fixture(scope="module")
def model():
    jcfg = qwen2_tiny(vocab_size=97)
    params = jqwen2.init_params(jcfg, jax.random.PRNGKey(0))
    # the port's own config, converted field by field
    tcfg = tconfig.QwenConfig(**dataclasses.asdict(jcfg))
    return jcfg, params, tcfg, params_from_jax(jax.tree.map(np.asarray, params))


def _setup(model, kind, prefill, int8=False, seed=0):
    """Both caches after the same 8-token prefill chunks, and the S verify
    embeddings."""
    jcfg, jparams, tcfg, tparams = model
    jp, tp = _policies(kind)
    shape = dict(num_layers=jcfg.num_layers, batch=B, num_kv_heads=jcfg.num_kv_heads,
                 head_dim=jcfg.head_dim)
    jc = jkv.init_cache(jp, dtype=jnp.int8 if int8 else jnp.float32, **shape)
    tc = tkv.init_cache(tp, device="cpu", dtype=torch.int8 if int8 else torch.float32, **shape)
    rng = np.random.default_rng(seed)
    left = prefill
    while left > 0:
        n = min(8, left)
        emb = (rng.standard_normal((B, n, jcfg.hidden_size)) * 0.1).astype(np.float32)
        _, jc = jqwen2.decode_chunk(jparams, jcfg, jp, jc, jnp.asarray(emb),
                                    jnp.full((B,), n, jnp.int32))
        tqwen2.decode_chunk(tparams, tcfg, tp, tc, _t(emb),
                            torch.full((B,), n, dtype=torch.int32))
        left -= n
    embs = (rng.standard_normal((B, S, jcfg.hidden_size)) * 0.1).astype(np.float32)
    return jp, tp, jc, tc, embs


def _sequential(model, tp, cache, embs, n_steps, valid_len=None):
    """n_steps 1-token passes of the port on a copy of the cache."""
    _, _, tcfg, tparams = model
    cache = cache.clone()
    hs = []
    for j in range(n_steps):
        v = (torch.ones((B,), dtype=torch.int32) if valid_len is None
             else (valid_len > j).to(torch.int32))
        hs.append(tqwen2.decode_chunk(tparams, tcfg, tp, cache, _t(embs[:, j:j + 1]), v))
    return (torch.cat(hs, dim=1) if hs else None), cache


def _assert_plans_equal(tplans, jplans, junk):
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(tplans, f).numpy(),
                                      np.asarray(getattr(jplans, f)), err_msg=f)
    keep = np.arange(tplans.meta_key_pos.shape[-1]) != junk   # junk key_pos is don't-care
    np.testing.assert_array_equal(tplans.meta_key_pos.numpy()[..., keep],
                                  np.asarray(jplans.meta_key_pos)[..., keep])


def _assert_cache_equal(a, b, policy, atol=2e-5):
    """Port cache ``a`` against a port or JAX cache ``b``: metadata exactly,
    occupied non-junk K/V to atol (an int8 cache compares dequantized)."""
    arr = (lambda x: x.numpy()) if isinstance(b.order, torch.Tensor) else np.asarray
    keep = np.arange(policy.num_slots) != policy.junk
    np.testing.assert_array_equal(a.order.numpy()[:, keep], arr(b.order)[:, keep])
    np.testing.assert_array_equal(a.key_pos.numpy()[:, keep], arr(b.key_pos)[:, keep])
    np.testing.assert_array_equal(a.seen.numpy(), arr(b.seen))
    np.testing.assert_array_equal(a.length.numpy(), arr(b.length))
    occ = ((a.order.numpy() >= 0) & keep[None, :])[None, :, :, None, None]
    for name, sname in (("k", "k_scale"), ("v", "v_scale")):
        xa = getattr(a, name).float().numpy()
        xb = arr(getattr(b, name)).astype(np.float32)
        if a.quantized:
            xa = xa * getattr(a, sname).numpy()[..., None]
            xb = xb * arr(getattr(b, sname))[..., None]
        np.testing.assert_allclose(np.where(occ, xa, 0.0), np.where(occ, xb, 0.0),
                                   rtol=2e-4, atol=atol)


STATES = [("none", 8), ("sliding", 40), ("sink", 24), ("sink", 40), ("sink", 80), ("static", 8)]


@pytest.mark.parametrize("kind,prefill", STATES)
def test_plan_compose_matches_jax(model, kind, prefill):
    """Every field of SpecPlans, for the 1-token composition (full and ragged
    rows) and for the frame composition (step = 3, one row with a padded
    tail)."""
    jp, tp, jc, tc, _ = _setup(model, kind, prefill)
    for valid, n_steps, step in [((S, S), S, 1), ((1, 3), S, 1), ((6, 3), 2, 3)]:
        jplans = jspec.plan_compose(jc, jp, jnp.asarray(valid, jnp.int32), n_steps, step=step)
        tplans = tspec.plan_compose(tc, tp, torch.tensor(valid, dtype=torch.int32), n_steps,
                                    step=step)
        _assert_plans_equal(tplans, jplans, tp.junk)


@pytest.mark.parametrize("kind,prefill", STATES)
def test_verify_pass_matches_jax_and_sequential(model, kind, prefill):
    """decode_chunk_spec: hidden states and in-flight K/V against JAX (1e-5),
    hidden states against the port's own S sequential 1-token passes (2e-5);
    it leaves the cache untouched; committing all S tokens gives the
    sequentially written cache and JAX's committed cache."""
    jcfg, jparams, tcfg, tparams = model
    jp, tp, jc, tc, embs = _setup(model, kind, prefill)
    before = tc.clone()
    full = torch.full((B,), S, dtype=torch.int32)
    jplans = jspec.plan_compose(jc, jp, jnp.full((B,), S, jnp.int32), S)
    tplans = tspec.plan_compose(tc, tp, full, S)
    jh, jik, jiv = jqwen2.decode_chunk_spec(jparams, jcfg, jp, jc, jnp.asarray(embs), jplans)
    th, tik, tiv = tqwen2.decode_chunk_spec(tparams, tcfg, tp, tc, _t(embs), tplans,
                                            replay=False)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tik.numpy(), np.asarray(jik), atol=ATOL)
    np.testing.assert_allclose(tiv.numpy(), np.asarray(jiv), atol=ATOL)
    for f in ("k", "v", "order", "key_pos", "seen", "length"):     # read-only
        assert torch.equal(getattr(tc, f), getattr(before, f)), f
    h_seq, cache_seq = _sequential(model, tp, tc, embs, S)
    np.testing.assert_allclose(th.numpy(), h_seq.numpy(), rtol=2e-5, atol=2e-5)

    tspec.commit_slots(tc, tplans, tik, tiv, full, tp.junk)
    tspec.select_meta(tc, tplans, full)
    _assert_cache_equal(tc, cache_seq, tp)
    jfull = jnp.full((B,), S, jnp.int32)
    jcommitted = jspec.select_meta(
        jspec.commit_slots(jc, jplans, jik, jiv, jfull, jp.junk), jplans, jfull)
    _assert_cache_equal(tc, jcommitted, tp)


@pytest.mark.parametrize("kind,m", [("sink", 0), ("sink", 3), ("none", 1), ("sliding", 2)])
def test_commit_prefix_matches_sequential(model, kind, m):
    """Committing m accepted tokens == running only m sequential passes;
    rejected rows go to the junk slot."""
    _, _, tcfg, tparams = model
    jp, tp, jc, tc, embs = _setup(model, kind, 80 if kind != "none" else 8)
    tplans = tspec.plan_compose(tc, tp, torch.full((B,), S, dtype=torch.int32), S)
    _, tik, tiv = tqwen2.decode_chunk_spec(tparams, tcfg, tp, tc, _t(embs), tplans, replay=False)
    _, cache_seq = _sequential(model, tp, tc, embs, m)
    mc = torch.full((B,), m, dtype=torch.int32)
    tspec.select_meta(tspec.commit_slots(tc, tplans, tik, tiv, mc, tp.junk), tplans, mc)
    _assert_cache_equal(tc, cache_seq, tp)


def test_ragged_valid_rows(model):
    """Per-row valid_len (carried token + differing draft counts): each row
    behaves like its own sequential run."""
    _, _, tcfg, tparams = model
    jp, tp, jc, tc, embs = _setup(model, "sink", 80)
    valid = torch.tensor([1, 3], dtype=torch.int32)
    tplans = tspec.plan_compose(tc, tp, valid, S)
    th, tik, tiv = tqwen2.decode_chunk_spec(tparams, tcfg, tp, tc, _t(embs), tplans,
                                            replay=False)
    h_seq, cache_seq = _sequential(model, tp, tc, embs, S, valid_len=valid)
    for b in range(B):
        n = int(valid[b])
        np.testing.assert_allclose(th.numpy()[b, :n], h_seq.numpy()[b, :n], rtol=2e-5, atol=2e-5)
    tspec.select_meta(tspec.commit_slots(tc, tplans, tik, tiv, valid, tp.junk), tplans, valid)
    _assert_cache_equal(tc, cache_seq, tp)


def test_int8_kv_verify_and_commit(model):
    """int8 KV cache: the verify pass reads the quantized cache (scales
    folded into score and probability columns) and the commit quantizes the
    in-flight block like write_layer. Against JAX at 1e-5 on the same
    quantized cache; against the sequential passes at 5e-3 / 2e-2 (a
    sequential pass attends to its own token after int8 rounding, the verify
    pass before), the bounds of tests/test_spec_decode.py."""
    jcfg, jparams, tcfg, tparams = model
    jp, tp, jc, tc, embs = _setup(model, "sink", 80, int8=True)
    # the two caches were quantized by two frameworks: hand JAX's to the port
    tc = tkv.KVCache(*(None if x is None else _t(x) for x in
                       (jc.k, jc.v, jc.key_pos, jc.order, jc.seen, jc.length,
                        jc.k_scale, jc.v_scale)))
    full = torch.full((B,), S, dtype=torch.int32)
    jplans = jspec.plan_compose(jc, jp, jnp.full((B,), S, jnp.int32), S)
    tplans = tspec.plan_compose(tc, tp, full, S)
    jh, _, _ = jqwen2.decode_chunk_spec(jparams, jcfg, jp, jc, jnp.asarray(embs), jplans)
    th, tik, tiv = tqwen2.decode_chunk_spec(tparams, tcfg, tp, tc, _t(embs), tplans)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    h_seq, cache_seq = _sequential(model, tp, tc, embs, S)
    np.testing.assert_allclose(th.numpy(), h_seq.numpy(), rtol=5e-3, atol=5e-3)
    tspec.select_meta(tspec.commit_slots(tc, tplans, tik, tiv, full, tp.junk), tplans, full)
    _assert_cache_equal(tc, cache_seq, tp, atol=2e-2)


def test_exact_branch_gate(model):
    """plans.exact is False while nothing was evicted and True in every
    post-fill state (8-token prefill chunks followed by 1-token steps leave
    a permanent position lag), as in JAX. Where the gate is False both
    branches of the port's verify pass are exact, so they must agree; where
    it is True only the exact one equals the sequential passes."""
    _, _, tcfg, tparams = model
    flags = {}
    for prefill in (0, 8, 24, 32, 40, 80):
        jp, tp, jc, tc, embs = _setup(model, "sink", prefill)
        valid = torch.full((B,), S, dtype=torch.int32)
        tplans = tspec.plan_compose(tc, tp, valid, S)
        jplans = jspec.plan_compose(jc, jp, jnp.full((B,), S, jnp.int32), S)
        flags[prefill] = bool(tplans.exact)
        assert flags[prefill] == bool(jplans.exact)
        if prefill in (8, 80):
            fast, exact = (tqwen2.decode_chunk_spec(
                tparams, tcfg, tp, tc, _t(embs),
                dataclasses.replace(tplans, exact=torch.tensor(side)), replay=False)[0]
                for side in (False, True))
            h_seq, _ = _sequential(model, tp, tc, embs, S)
            np.testing.assert_allclose(exact.numpy(), h_seq.numpy(), rtol=2e-5, atol=2e-5)
            if prefill == 8:
                np.testing.assert_allclose(fast.numpy(), exact.numpy(), rtol=2e-5, atol=2e-5)
            else:
                assert np.abs(fast.numpy() - h_seq.numpy()).max() > 1e-4
    assert not flags[0] and not flags[8] and not flags[24], flags
    assert all(flags[p] for p in (32, 40, 80)), flags


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_speculative_attention_matches_jax(model, exact, int8):
    """speculative_attention alone, on random q / in-flight K/V over a
    post-fill sink cache, both branches, f32 and int8 KV: 1e-5."""
    jcfg = model[0]
    jp, tp, jc, tc, _ = _setup(model, "sink", 40, int8=int8)
    if int8:
        tc = tkv.KVCache(*(None if x is None else _t(x) for x in
                           (jc.k, jc.v, jc.key_pos, jc.order, jc.seen, jc.length,
                            jc.k_scale, jc.v_scale)))
    jplans = jspec.plan_compose(jc, jp, jnp.full((B,), S, jnp.int32), S)
    tplans = tspec.plan_compose(tc, tp, torch.full((B,), S, dtype=torch.int32), S)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, jcfg.num_heads, jcfg.head_dim)).astype(np.float32)
    k_if, v_if = (rng.standard_normal((B, S, jcfg.num_kv_heads, jcfg.head_dim))
                  .astype(np.float32) for _ in range(2))
    ref = jattn.speculative_attention(
        jnp.asarray(q), jc.k[0], jc.v[0], jnp.asarray(k_if), jnp.asarray(v_if), jplans,
        kv_scales=(jc.k_scale[0], jc.v_scale[0]) if int8 else None,
        rope_theta=jcfg.rope_theta, sink_slots=jp.num_sink, sink_policy=True, exact=exact)
    tables = tattn.spec_tables(tplans, True, jcfg.head_dim, jcfg.rope_theta, exact)
    out = tattn.speculative_attention(
        _t(q), tc.k[0], tc.v[0], _t(k_if), _t(v_if), tables, sink_slots=jp.num_sink,
        kv_scales=(tc.k_scale[0], tc.v_scale[0]) if int8 else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _attend_step_by_step(tp, tcfg, cache, q, k, v, valid_len, n_steps, step):
    """What the sequential passes compute in one layer (layer 0): each step's
    keys written by ``write_layer`` and its rows attended by
    ``cached_attention``, on a copy of the cache."""
    cache = cache.clone()
    out = []
    for j in range(n_steps):
        rows = slice(j * step, (j + 1) * step)
        plan = tkv.plan_update(cache, tp, torch.clamp(valid_len - j * step, 0, step), step)
        tables = tattn.chunk_tables(plan, tp, tcfg.head_dim, tcfg.rope_theta)
        tkv.write_layer(cache.k[0], cache.v[0], k[:, rows], v[:, rows], plan,
                        rot=(tables.w_cos, tables.w_sin))
        out.append(tattn.cached_attention(q[:, rows], cache.k[0], cache.v[0], tables))
        tkv.advance(cache, plan)
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("kind,prefill,valid,step", [
    *[(k, p, (S, S), 1) for k, p in STATES],
    ("sink", 80, (1, 3), 1),            # ragged rows
    ("sink", 40, (4, 2), 2),            # two frame steps of two tokens, one row padded
])
def test_replayed_attention_is_the_sequential_steps(model, kind, prefill, valid, step):
    """replayed_attention on random q / in-flight K/V: bit for bit the S
    sequential steps' write-then-attend of layer 0, and the cache's K/V
    untouched."""
    jcfg, _, tcfg, _ = model
    _, tp, _, tc, _ = _setup(model, kind, prefill)
    valid = torch.tensor(valid, dtype=torch.int32)
    plans = tspec.plan_compose(tc, tp, valid, S // step, step=step)
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((B, S, jcfg.num_heads, jcfg.head_dim)).astype(np.float32))
    k, v = (_t(rng.standard_normal((B, S, jcfg.num_kv_heads, jcfg.head_dim)).astype(np.float32))
            for _ in range(2))
    tables = tattn.step_tables(plans, tp, tcfg.head_dim, tcfg.rope_theta)
    k_rot = tattn.apply_rope(k, tables.w_cos, tables.w_sin)
    before = tc.clone()
    out = tattn.replayed_attention(q, tc.k[0], tc.v[0], k_rot, v, tables)
    ref = _attend_step_by_step(tp, tcfg, before, q, k, v, valid, S // step, step)
    assert out.shape == ref.shape and torch.equal(out, ref)
    assert torch.equal(tc.k, before.k) and torch.equal(tc.v, before.v)


@pytest.mark.parametrize("kind,prefill", STATES)
def test_replayed_verify_pass_matches_jax_and_sequential(model, kind, prefill):
    """decode_chunk_spec with the replayed attention (asked for, and the
    default on an f32 cache): hidden states and in-flight K/V against JAX's
    verify pass (1e-5), hidden states against the sequential passes (2e-5),
    layer 0's in-flight K/V (before any attention) equal to the composed
    pass's, and the cache left as it was."""
    jcfg, jparams, tcfg, tparams = model
    jp, tp, jc, tc, embs = _setup(model, kind, prefill)
    before = tc.clone()
    full = torch.full((B,), S, dtype=torch.int32)
    jplans = jspec.plan_compose(jc, jp, jnp.full((B,), S, jnp.int32), S)
    tplans = tspec.plan_compose(tc, tp, full, S)
    jh, jik, jiv = jqwen2.decode_chunk_spec(jparams, jcfg, jp, jc, jnp.asarray(embs), jplans)
    th, tik, tiv = tqwen2.decode_chunk_spec(tparams, tcfg, tp, tc, _t(embs), tplans, replay=True)
    # an f32 cache: the default derives the replay from the cache
    assert torch.equal(tqwen2.decode_chunk_spec(tparams, tcfg, tp, tc, _t(embs), tplans)[0], th)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tik.numpy(), np.asarray(jik), atol=ATOL)
    np.testing.assert_allclose(tiv.numpy(), np.asarray(jiv), atol=ATOL)
    for f in ("k", "v", "order", "key_pos", "seen", "length"):     # read, not written
        assert torch.equal(getattr(tc, f), getattr(before, f)), f
    _, cik, civ = tqwen2.decode_chunk_spec(tparams, tcfg, tp, tc, _t(embs), tplans, replay=False)
    assert torch.equal(tik[0], cik[0]) and torch.equal(tiv[0], civ[0])
    h_seq, _ = _sequential(model, tp, tc, embs, S)
    np.testing.assert_allclose(th.numpy(), h_seq.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kind,prefill", STATES)
def test_replayed_frame_steps_match_jax_and_sequential(model, kind, prefill):
    """The fused-scoring form of the replayed verify pass: 2 composed steps
    of 2 tokens (frames of 2), full and with row 1's second step padded:
    hidden states against JAX's verify pass over the same plans (1e-5) and
    against the port's 2-token write passes one after another (2e-5), on the
    valid rows; the cache only read."""
    jcfg, jparams, tcfg, tparams = model
    jp, tp, jc, tc, embs = _setup(model, kind, prefill)
    before = tc.clone()
    for valid in ((4, 4), (4, 2)):
        jplans = jspec.plan_compose(jc, jp, jnp.asarray(valid, jnp.int32), 2, step=2)
        tplans = tspec.plan_compose(tc, tp, torch.tensor(valid, dtype=torch.int32), 2, step=2)
        jh, _, _ = jqwen2.decode_chunk_spec(jparams, jcfg, jp, jc, jnp.asarray(embs), jplans)
        th, _, _ = tqwen2.decode_chunk_spec(tparams, tcfg, tp, tc, _t(embs), tplans,
                                            replay=True)
        for f in ("k", "v", "order", "key_pos", "seen", "length"):
            assert torch.equal(getattr(tc, f), getattr(before, f)), f
        seq, hs = tc.clone(), []
        for j in range(2):
            v = torch.clamp(torch.tensor(valid, dtype=torch.int32) - 2 * j, 0, 2)
            hs.append(tqwen2.decode_chunk(tparams, tcfg, tp, seq, _t(embs[:, 2 * j:2 * j + 2]),
                                          v))
        h_seq = torch.cat(hs, dim=1)
        for b in range(B):
            n = valid[b]
            np.testing.assert_allclose(th.numpy()[b, :n], np.asarray(jh)[b, :n], atol=ATOL)
            np.testing.assert_allclose(th.numpy()[b, :n], h_seq.numpy()[b, :n], rtol=2e-5,
                                       atol=2e-5)


def test_replayed_attention_refuses_an_int8_cache(model):
    """An int8 cache's sequential writes are quantised: the replay does not
    take it (``generate_spec`` composes there, as JAX does)."""
    jcfg, _, tcfg, _ = model
    _, tp, _, tc, _ = _setup(model, "sink", 40, int8=True)
    plans = tspec.plan_compose(tc, tp, torch.full((B,), S, dtype=torch.int32), S)
    q = torch.zeros((B, S, jcfg.num_heads, jcfg.head_dim))
    kv = torch.zeros((B, S, jcfg.num_kv_heads, jcfg.head_dim))
    tables = tattn.step_tables(plans, tp, tcfg.head_dim, tcfg.rope_theta)
    with pytest.raises(ValueError, match="int8 cache"):
        tattn.replayed_attention(q, tc.k[0], tc.v[0], kv, kv, tables)


def test_draft_history_and_ngram_draft_match_jax():
    """build_draft_hist (with and without a context, ragged rows) and
    ngram_draft (trigram, bigram, unigram and no match; the latest match
    wins) against JAX on a small vocabulary, where repeats are common."""
    rng = np.random.default_rng(4)
    for trial in range(6):
        Bn, C, P, extra = 3, 6, 9, 5
        ids = rng.integers(0, 5, (Bn, P)).astype(np.int32)
        lens = rng.integers(1, P + 1, (Bn,)).astype(np.int32)
        ctx = rng.integers(0, 5, (Bn, C)).astype(np.int32)
        ctx_len = rng.integers(0, C + 1, (Bn,)).astype(np.int32)
        for with_ctx in (False, True):
            ja = (jnp.asarray(ctx), jnp.asarray(ctx_len)) if with_ctx else (None, None)
            ta = (_t(ctx), _t(ctx_len)) if with_ctx else (None, None)
            jh, jl = jspec.build_draft_hist(*ja, jnp.asarray(ids), jnp.asarray(lens), extra)
            th, tl = tspec.build_draft_hist(*ta, _t(ids), _t(lens), extra)
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
            carry = rng.integers(0, 6, (Bn,)).astype(np.int32)    # 5 never occurs: no match
            for n_draft in (3, 7):
                jd = jspec.ngram_draft(jh, jl, jnp.asarray(carry), n_draft)
                td = tspec.ngram_draft(th, tl, _t(carry), n_draft)
                np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    # the tie rule, spelled out: "a b X ... a b Y ... a b" continues with Y
    hist = torch.tensor([[1, 2, 7, 1, 2, 8, 9, 1, -1, -1]], dtype=torch.int32)
    d = tspec.ngram_draft(hist, torch.tensor([8], dtype=torch.int32),
                          torch.tensor([2], dtype=torch.int32), 2)
    assert d.tolist() == [[8, 9]]
