"""The verify pass's attention in one launch of the cached-attention kernel
(``decode_attention_steps`` under ``replayed_attention``) on the CPU: its
plain version against the write-and-restore loop, the oracle (each composed
step's in-flight keys and values written into their slots, the step's rows
attended through ``decode_attention`` with its own tables, the slots
restored), bit for bit, over caches of every policy
through the window fill, ragged rows, token and frame-like steps and every
pair of q and cache dtypes the card takes; the cache only read; where each
slot's in-flight row comes from; each step's plan equal to its write pass's
at every 7B shape; what the wrapper refuses. No JAX: the verify pass against
JAX's is in tests/test_torch_spec.py and tests/test_torch_trigger.py."""

import numpy as np
import pytest
import torch

from aha_tpu_torch.ops import attention as tattn
from aha_tpu_torch.ops import kv_cache as tkv
from aha_tpu_torch.ops import spec_decode as tspec
from aha_tpu_torch.ops.kernels import decode_attention as da
from aha_tpu_torch.ops.rope import apply_rope

B, NH, KVH, DH = 2, 4, 2, 16
THETA = 10_000.0
BF, F32 = torch.bfloat16, torch.float32
# (policy, prefill): the fill states of tests/test_torch_spec.py (window 32, 4 sinks)
STATES = [("none", 8), ("sliding", 40), ("sink", 24), ("sink", 40), ("sink", 80), ("static", 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policy(kind):
    return tkv.CachePolicy(kind, window=512 if kind == "none" else 32, num_sink=4)


def _cache(kind, prefill, dtype, seed=0):
    """A one-layer cache after ``prefill`` tokens written in chunks of 8 from a
    numpy seed, as the write passes write them."""
    policy = _policy(kind)
    cache = tkv.init_cache(policy, num_layers=1, batch=B, num_kv_heads=KVH, head_dim=DH,
                           dtype=dtype, device="cpu")
    rng = np.random.default_rng(seed)
    left = prefill
    while left > 0:
        n = min(8, left)
        plan = tkv.plan_update(cache, policy, torch.full((B,), n, dtype=torch.int32), n)
        t = tattn.chunk_tables(plan, policy, DH, THETA)
        k, v = (torch.from_numpy(rng.standard_normal((B, n, KVH, DH)).astype(np.float32))
                for _ in range(2))
        tkv.write_layer(cache.k[0], cache.v[0], k, v, plan, rot=(t.w_cos, t.w_sin))
        tkv.advance(cache, plan)
        left -= n
    return policy, cache


def replay_loop(q, k_cache, v_cache, k_infl, v_infl, slots, w_cos, w_sin, steps):
    """The oracle: the verify pass's attention as one write pass after another,
    each step's rows written into the cache, the slots restored after."""
    B_, N = slots.shape
    step = N // len(steps)
    bidx = torch.arange(B_, device=q.device)[:, None]
    every = (bidx, slots.long())
    old_k, old_v = k_cache[every], v_cache[every]
    q_rot = apply_rope(q.float(), w_cos, w_sin).to(q.dtype)
    out = []
    for j, t in enumerate(steps):
        rows = slice(j * step, (j + 1) * step)
        mine = (bidx, slots[:, rows].long())
        k_cache[mine] = k_infl[:, rows].to(k_cache.dtype)
        v_cache[mine] = v_infl[:, rows].to(v_cache.dtype)
        out.append(da.decode_attention(q_rot[:, rows].contiguous(), k_cache, v_cache, t.d_cos,
                                       t.d_sin, t.mask_order, t.mask_g))
    k_cache[every], v_cache[every] = old_k, old_v
    return torch.cat(out, dim=1)


def _inputs(policy, cache, n, step, valid, qdt, seed=5):
    plans = tspec.plan_compose(cache, policy, torch.tensor(valid, dtype=torch.int32), n,
                               step=step)
    rng = np.random.default_rng(seed)
    N = n * step
    q = torch.from_numpy(rng.standard_normal((B, N, NH, DH)).astype(np.float32)).to(qdt)
    k, v = (torch.from_numpy(rng.standard_normal((B, N, KVH, DH)).astype(np.float32)).to(qdt)
            for _ in range(2))
    tables = tattn.step_tables(plans, policy, DH, THETA)
    k_rot = apply_rope(k.float(), tables.w_cos, tables.w_sin).to(qdt)
    return plans, tables, q, k_rot, v


# (policy, prefill, steps, rows a step, valid rows of each batch row, q dtype, cache dtype)
CASES = [(k, p, 4, 1, (4, 4), F32, F32) for k, p in STATES]
CASES += [(k, p, 3, 5, (15, 15), F32, F32) for k, p in STATES]        # frame-like steps
CASES += [("sink", 80, 4, 1, (1, 3), F32, F32),                         # ragged rows
          ("sink", 40, 3, 5, (15, 5), F32, F32),                        # a padded frame tail
          ("sink", 24, 2, 2, (4, 4), F32, F32),
          ("sink", 80, 8, 1, (8, 8), F32, F32),
          ("sliding", 40, 3, 5, (15, 15), BF, BF),                      # the card's dtypes
          ("sink", 40, 3, 5, (15, 10), F32, BF),                        # f32 q, bf16 cache
          ("sink", 80, 4, 1, (4, 4), BF, F32),                          # bf16 q, f32 cache
          ("static", 8, 3, 5, (15, 15), BF, BF)]


@pytest.mark.parametrize("kind,prefill,n,step,valid,qdt,kvdt", CASES,
                         ids=lambda v: str(v).replace("torch.", "").replace(" ", ""))
def test_steps_equal_the_replay_loop(kind, prefill, n, step, valid, qdt, kvdt):
    """replayed_attention (one call of decode_attention_steps) against the
    write-and-restore loop: the same bits, the same dtype, and
    the cache's K/V and metadata untouched (the loop runs on a copy)."""
    policy, cache = _cache(kind, prefill, kvdt)
    plans, tables, q, k_rot, v = _inputs(policy, cache, n, step, valid, qdt)
    before = cache.clone()
    out = tattn.replayed_attention(q, cache.k[0], cache.v[0], k_rot, v, tables)
    for f in ("k", "v", "order", "key_pos", "seen", "length"):
        assert torch.equal(getattr(cache, f), getattr(before, f)), f
    steps = [tattn.chunk_tables(p, policy, DH, THETA) for p in plans.steps]
    ref = replay_loop(q, before.k[0], before.v[0], k_rot, v, plans.slots, tables.w_cos,
                      tables.w_sin, steps)
    assert out.dtype == ref.dtype == qdt and out.shape == ref.shape
    assert torch.equal(out, ref)


@pytest.mark.parametrize("kind,prefill", STATES)
@pytest.mark.parametrize("n,step,valid", [(4, 1, (4, 2)), (3, 5, (15, 10))])
def test_step_sources_are_the_loops_writes(kind, prefill, n, step, valid):
    """step_sources: after step j's writes, each non-junk slot holds the
    in-flight row the loop last wrote there (its row index written as the
    value), or nothing in-flight (-1)."""
    policy, cache = _cache(kind, prefill, F32)
    plans = tspec.plan_compose(cache, policy, torch.tensor(valid, dtype=torch.int32), n,
                               step=step)
    src = tattn.step_sources(plans.slots, n, policy.num_slots)
    assert src.shape == (n, B, policy.num_slots) and src.dtype == torch.int32
    held = torch.full((B, policy.num_slots), -1, dtype=torch.int32)
    bidx = torch.arange(B)[:, None]
    keep = torch.arange(policy.num_slots) != policy.junk
    for j in range(n):
        rows = slice(j * step, (j + 1) * step)
        held[bidx, plans.slots[:, rows].long()] = torch.arange(j * step, (j + 1) * step,
                                                               dtype=torch.int32)
        assert torch.equal(src[j][:, keep], held[:, keep]), j


def test_steps_plain_reads_each_step_through_its_overlay():
    """decode_attention_steps_plain hands ``attend`` each step's rows, tables
    and overlaid cache (the split emulation at the step's plan here), and the
    overlaid copy is the cache with the in-flight rows at their slots."""
    policy, cache = _cache("sink", 40, F32)
    plans, tables, q, k_rot, v = _inputs(policy, cache, 3, 5, (15, 15), F32)
    q_rot = apply_rope(q, tables.w_cos, tables.w_sin)
    args = (q_rot, cache.k[0], cache.v[0], k_rot, v, tables.d_cos, tables.d_sin,
            tables.mask_order, tables.mask_g, tables.src)
    pl = da.plan_steps(3, B, 15, NH, KVH, DH, policy.num_slots, F32, F32, sms=1)
    split = lambda *a: da.decode_attention_split_plain(*a, pl=pl)
    got = da.decode_attention_steps_plain(*args, attend=split)
    plain = da.decode_attention_steps_plain(*args)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    k_j, v_j = da.overlaid(cache.k[0], cache.v[0], k_rot, v, tables.src[2])
    bidx = torch.arange(B)[:, None]
    last = plans.slots[:, 10:15].long()
    assert torch.equal(k_j[bidx, last], k_rot[:, 10:15]) and torch.equal(v_j[bidx, last],
                                                                          v[:, 10:15])
    untouched = tables.src[2] < 0
    assert torch.equal(k_j[untouched], cache.k[0][untouched])


# (B, steps, rows a step, q heads, kv heads, q dtype, cache dtype): the 7B's verify passes,
# fused frame scoring (4 or 8 frames of 49 tokens; 50 with a CLS token) and speculative
# generation (4 and 8 tokens), at B 1 and 8, f32 q behind a peft artifact's f32 projector
# over the bf16 cache and over an f32 cache, a rank's heads at model 2 and 4
SEVEN_B = [(1, 4, 49, 28, 4, BF, BF), (1, 8, 49, 28, 4, BF, BF), (1, 4, 50, 28, 4, BF, BF),
           (1, 4, 1, 28, 4, BF, BF), (1, 8, 1, 28, 4, BF, BF), (8, 4, 49, 28, 4, BF, BF),
           (8, 4, 1, 28, 4, BF, BF), (8, 8, 1, 28, 4, BF, BF), (1, 4, 49, 28, 4, F32, BF),
           (1, 4, 49, 28, 4, F32, F32), (8, 4, 49, 14, 2, BF, BF), (8, 4, 1, 14, 2, BF, BF),
           (8, 8, 1, 14, 2, BF, BF), (8, 4, 49, 7, 1, BF, BF)]


@pytest.mark.parametrize("shape", SEVEN_B,
                         ids=lambda s: "-".join(str(x).replace("torch.", "") for x in s))
def test_plan_steps_is_the_write_pass_plan(shape):
    """Each step of a verify pass launches as a write pass of its rows does:
    the same path, tiles and splits, so the same order of sums; the steps'
    blocks side by side stay within the grid."""
    Bn, n, step, nh, kvh, qdt, kvdt = shape
    pl = da.plan_steps(n, Bn, n * step, nh, kvh, 128, 2049, qdt, kvdt)
    assert pl == da.plan(Bn, step, nh, kvh, 128, 2049, qdt, kvdt)
    want = (da.CUDA_CORES if (nh // kvh) * step < da.WGMMA_MIN_ROWS else
            da.WGMMA if qdt == BF else da.WGMMA_F32)
    assert pl.path == want
    assert Bn * kvh * n <= 65535 and pl.blocks == Bn * kvh * pl.row_tiles * pl.splits


def _steps_args(qdt=F32, kvdt=F32, n=2, S=3, Wp=40, misalign=False):
    N = n * S
    z = torch.zeros
    q = z(B, N, NH, DH, dtype=qdt)
    if misalign:
        q = z(B * N * NH * DH + 2, dtype=qdt)[2:].view(B, N, NH, DH)
    return (q, z(B, Wp, KVH, DH, dtype=kvdt), z(B, Wp, KVH, DH, dtype=kvdt),
            z(n, B, Wp, DH), z(n, B, Wp, DH), z(n, B, Wp, dtype=torch.int32),
            z(B, N, dtype=torch.int32), None,
            (z(B, N, KVH, DH, dtype=kvdt), z(B, N, KVH, DH, dtype=kvdt),
             z(n, B, Wp, dtype=torch.int32)))


def test_steps_wrapper_refuses():
    """What decode_attention_steps refuses before a launch: an int8 cache (the
    composed pass takes it), in-flight rows in another dtype than the cache,
    rows that are not whole steps, a misaligned q, tables without the steps'
    axis; and a device that is neither the CPU nor a card."""
    a = _steps_args()
    da._check(*a[:8], infl=a[8])
    i8 = _steps_args(kvdt=torch.int8)
    scales = (torch.ones(B, 40, KVH), torch.ones(B, 40, KVH))
    with pytest.raises(ValueError, match="cache dtype"):
        da._check(*i8[:7], scales, infl=i8[8])
    with pytest.raises(ValueError, match="k_infl dtype"):
        da._check(*a[:8], infl=(a[8][0].to(BF), *a[8][1:]))
    odd = list(_steps_args())
    odd[0] = odd[0][:, :5].contiguous()
    odd[6] = odd[6][:, :5].contiguous()
    with pytest.raises(ValueError, match="equal rows"):
        da._check(*odd[:8], infl=(odd[8][0][:, :5].contiguous(), odd[8][1][:, :5].contiguous(),
                                  odd[8][2]))
    m = _steps_args(misalign=True)
    with pytest.raises(ValueError, match="16-byte"):
        da._check(*m[:8], infl=m[8])
    flat = list(a)
    flat[3], flat[4] = flat[3][0], flat[4][0]
    with pytest.raises(ValueError, match="cos shape"):
        da._check(*flat[:8], infl=flat[8])
    q, k, v, cos, sin, order, g = (t.to("meta") for t in a[:7])
    ki, vi, src = (t.to("meta") for t in a[8])
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_attention_steps(q, k, v, ki, vi, cos, sin, order, g, src)
