"""Cached GQA attention over the ring-buffer cache: the CUDA kernels of
``csrc/decode_attention.cu`` and their plain PyTorch versions.

Counterpart of ``aha_tpu/ops/pallas/decode_attention.py::
cached_decode_attention``, with the same contract: ``q_rot`` is already
rotated at the chunk's write positions; each cached key gets a further
per-slot rotation by (cos, sin); a slot is visible to query s iff
``order >= 0 & order <= g[s]``; in int8 KV mode the per-(slot, head) scales
fold into the score and probability columns.

The kernels split the window over blocks and merge the splits' softmax
states in a fixed order (``plan`` chooses path and splits;
``decode_attention_split_plain`` is the same arithmetic in PyTorch). f32 q
against a bf16 cache is read as it lies: the kernels widen it on load, as the
TPU kernel does.

``decode_attention_steps`` is the verify pass's form of the same kernels:
the rows of n composed steps in one launch, step j's rows attending as its
write pass would, over the cache with the in-flight rows of steps <= j
overlaid at their slots (``src``), read-only; per step the plan, the slot
tiles, the splits and the merge order of a write pass of that many rows, so
the write passes' bits.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches, or the call raises. ``LAUNCHES["decode_attention"]`` (and
``["decode_attention_steps"]``) count the launches,
``PATH_LAUNCHES["decode_attention/<path>/<q>-<kv>"]`` them by path and types
(``decode_attention/wgmma/f32-bf16``: f32 q against a bf16 cache on the
tensor cores).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ..rope import rotate_half
from . import LAUNCHES, PATH_LAUNCHES, _build
from .int8_matmul import num_sms
from .quantize_rows import split_bf16x3_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HEAD_DIMS = (16, 32, 64, 128)

CUDA_CORES = 0           # f32 arithmetic, 16 rows and 32-slot tiles a block
WGMMA = 1                # bf16 q on the tensor cores, 64 rows and 64-slot tiles a block
WGMMA_F32 = 2            # f32 q on the tensor cores as bf16 planes, the same tiles
WGMMA_MIN_ROWS = 16      # rows per kv head (n_rep * S) from which Dh 128 takes the tensor cores
PATH_NAMES = {CUDA_CORES: "cuda_cores", WGMMA: "wgmma", WGMMA_F32: "wgmma"}
# blocks of a path that one SM holds at once (the CUDA-core kernel: 128 threads of
# 128 registers; the bf16 tensor-core kernel: 84 KB of shared memory; the f32 one:
# three q planes and two stages of two key planes and one or two V planes, 146 or
# 179 KB), and the least slot tiles a split of several walks (a tensor-core block
# loads 64 query rows first)
RESIDENT = {CUDA_CORES: 4, WGMMA: 2, WGMMA_F32: 1}
MIN_TILES = {CUDA_CORES: 1, WGMMA: 3, WGMMA_F32: 3}
_SHORT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}


def decode_attention_plain(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales=None):
    """q_rot [B, S, NH, Dh]; k/v cache [B, Wp, KVH, Dh]; cos/sin [B, Wp, Dh]
    f32; order [B, Wp] int32; g [B, S] int32; kv_scales (k_scale, v_scale)
    [B, Wp, KVH] f32 for an int8 cache. Returns [B, S, NH, Dh] in q's dtype;
    a row that sees no slot gets zeros. All math in f32."""
    B, S, NH, Dh = q_rot.shape
    KVH = k_cache.shape[2]
    kf = k_cache.float()
    k_rot = kf * cos[:, :, None, :] + rotate_half(kf) * sin[:, :, None, :]
    qg = q_rot.float().reshape(B, S, KVH, NH // KVH, Dh)
    s = torch.einsum("bsgrd,bwgd->bgrsw", qg, k_rot) * (1.0 / math.sqrt(Dh))
    if kv_scales is not None:
        s = s * kv_scales[0].float().transpose(1, 2)[:, :, None, None, :]
    order = order[:, None, :]
    mask = ((order >= 0) & (order <= g[:, :, None]))[:, None, None]   # [B,1,1,S,Wp]
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                                  # [B,KVH,rep,S]
    if kv_scales is not None:
        p = p * kv_scales[1].float().transpose(1, 2)[:, :, None, None, :]
    o = torch.einsum("bgrsw,bwgd->bsgrd", p, v_cache.float())
    o = o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, S, NH, Dh).to(q_rot.dtype)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How a call is launched: the path; its rows and slots per tile; the
    slots of each split (whole slot tiles; the last split ends at Wp) and
    the number of splits, none of them empty; the blocks of the attention
    kernel, (batch row, kv head, row tile, split). With one split the blocks
    write the output and no merge runs."""
    path: int
    row_tile: int
    row_tiles: int
    slot_tile: int
    span: int
    splits: int
    blocks: int

    def bounds(self, Wp: int) -> list[tuple[int, int]]:
        """Each split's slots [lo, hi), in split order."""
        return [(i * self.span, min(Wp, (i + 1) * self.span)) for i in range(self.splits)]


@functools.lru_cache(maxsize=None)
def plan(B: int, S: int, NH: int, KVH: int, Dh: int, Wp: int, q_dtype: torch.dtype,
         kv_dtype: torch.dtype, *, sms: int = 132) -> Plan:
    """The launch of ``decode_attention`` on a card of ``sms`` SMs. Tensor
    cores at head size 128 from ``WGMMA_MIN_ROWS`` rows per kv head: bf16 q
    with a bf16 or int8 cache, f32 q with a bf16 or f32 cache (as bf16
    planes); CUDA cores otherwise. The splits: ``plan_on``. Pure (no card is
    asked) and remembered: a path's shapes recur with every pass."""
    M = (NH // KVH) * S
    path = CUDA_CORES
    if Dh == 128 and M >= WGMMA_MIN_ROWS:
        if q_dtype == torch.bfloat16 and kv_dtype in (torch.bfloat16, torch.int8):
            path = WGMMA
        elif q_dtype == torch.float32 and kv_dtype in (torch.bfloat16, torch.float32):
            path = WGMMA_F32
    return plan_on(path, B, S, NH, KVH, Wp, sms=sms)


def plan_on(path: int, B: int, S: int, NH: int, KVH: int, Wp: int, *, sms: int = 132) -> Plan:
    """The splits of a launch on ``path``, from one batch row's blocks and
    never from B, so that a row sums in the same order in a batch of any size
    (a stream scored in a batch of 8 gets its bits alone): the window split
    into as many parts as one round of resident blocks holds for one row
    (``RESIDENT`` a SM), each of at least ``MIN_TILES`` slot tiles, then
    evened out over the slot tiles: a 7B token is 4 kv heads x 65 splits of 32
    slots (260 blocks a row), a 49-row bf16 frame chunk 24 row tiles x 11
    splits of 192, an f32 one 24 x 5 of 448. Where one row's tiles fill the
    round, one split."""
    M = (NH // KVH) * S
    row_tile, slot_tile = (16, 32) if path == CUDA_CORES else (64, 64)
    row_tiles = -(-M // row_tile)
    base = KVH * row_tiles             # one batch row's blocks before any split
    n_tiles = -(-Wp // slot_tile)
    want = max(1, min(RESIDENT[path] * sms // base, n_tiles // MIN_TILES[path]))
    per = -(-n_tiles // want)          # slot tiles per split
    splits = -(-n_tiles // per)
    return Plan(path, row_tile, row_tiles, slot_tile, per * slot_tile, splits,
                B * base * splits)


def decode_attention_split_plain(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales=None, *,
                                 pl: Plan, bf16_products: bool = False, f32_planes: bool = False):
    """The kernels' arithmetic in PyTorch: each split of ``pl`` walks its
    slots in ``pl.slot_tile`` tiles with a running maximum, sum and
    accumulator, and the splits merge in split order (M = max m_i, weights
    e^(m_i - M), a row that saw nothing anywhere gives zeros).
    ``bf16_products``: the bf16 tensor-core path's roundings, the rotated key
    and p (times the V scale) to bf16 before their products, an int8 V
    widened to bf16 (exact). ``f32_planes``: the f32 tensor-core path's
    operands, q as three bf16 planes (``split_bf16x3_plain``), the rotated key
    and an f32 V as two (hi = bf16(x), lo = bf16(x - hi)), scores
    (q_hi + q_mid + q_lo) k_hi + (q_hi + q_mid) k_lo, p as three planes (their
    sum is p) and o += p v_hi + p_hi v_lo; each product of bf16 planes is
    exact in f32, only the order of the f32 sums differs. Same contract as
    ``decode_attention_plain``."""
    B, S, NH, Dh = q_rot.shape
    Wp, KVH = k_cache.shape[1], k_cache.shape[2]
    kf = k_cache.float()
    k_rot = kf * cos[:, :, None, :] + rotate_half(kf) * sin[:, :, None, :]
    vf = v_cache.float()
    if bf16_products:
        k_rot = k_rot.to(torch.bfloat16).float()
    k_lo = v_lo = q_hm = None
    if f32_planes:
        k_rot, k_lo = _two_planes(k_rot)
        vf, v_lo = _two_planes(vf)
        q_hi, q_mid, _ = split_bf16x3_plain(q_rot).float()
        q_hm = (q_hi + q_mid).reshape(B, S, KVH, NH // KVH, Dh).permute(0, 2, 3, 1, 4)
    qg = q_rot.float().reshape(B, S, KVH, NH // KVH, Dh).permute(0, 2, 3, 1, 4)   # [B,KVH,rep,S,Dh]
    visible = ((order[:, None, :] >= 0) & (order[:, None, :] <= g[:, :, None]))[:, None, None]
    ks = vs = None
    if kv_scales is not None:
        ks, vs = (t.float().transpose(1, 2)[:, :, None, None, :] for t in kv_scales)
    scale = 1.0 / math.sqrt(Dh)
    neg = torch.full(qg.shape[:-1], float("-inf"), device=qg.device)
    parts = []
    for lo, hi in pl.bounds(Wp):
        m, l, acc = neg.clone(), torch.zeros_like(neg), torch.zeros_like(qg)
        for t0 in range(lo, hi, pl.slot_tile):
            t1 = min(hi, t0 + pl.slot_tile)
            s = torch.einsum("bgrsd,bwgd->bgrsw", qg, k_rot[:, t0:t1])
            if f32_planes:
                s = s + torch.einsum("bgrsd,bwgd->bgrsw", q_hm, k_lo[:, t0:t1])
            s = s * scale
            if ks is not None:
                s = s * ks[..., t0:t1]
            s = s.masked_fill(~visible[..., t0:t1], float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            seen = m_new > float("-inf")
            alpha = torch.where(seen, torch.exp(m - m_new), torch.ones_like(m))
            p = torch.where(seen[..., None], torch.exp(s - m_new[..., None]), torch.zeros_like(s))
            l = l * alpha + p.sum(dim=-1)
            if vs is not None:
                p = p * vs[..., t0:t1]
            if bf16_products:
                p = p.to(torch.bfloat16).float()
            pv = torch.einsum("bgrsw,bwgd->bgrsd", p, vf[:, t0:t1])
            if f32_planes:
                p_hi = split_bf16x3_plain(p)[0].float()
                pv = pv + torch.einsum("bgrsw,bwgd->bgrsd", p_hi, v_lo[:, t0:t1])
            acc = acc * alpha[..., None] + pv
            m = m_new
        parts.append((m, l, acc))
    top = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    seen = top > float("-inf")
    l, acc = torch.zeros_like(top), torch.zeros_like(qg)
    for m_i, l_i, acc_i in parts:
        w = torch.where(seen, torch.exp(m_i - top), torch.zeros_like(top))
        l = l + l_i * w
        acc = acc + acc_i * w[..., None]
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, NH, Dh).to(q_rot.dtype)


def _two_planes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (f32) as two bf16 planes, hi = bf16(x) and lo = bf16(x - hi), as f32:
    16 significant bits, |x - hi - lo| <= 2^-18 |x|; lo is 0 where x is a
    bf16 value (a bf16 cache's V; a key whose residual rotation is the
    identity)."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _check(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales, infl=None):
    """``infl``: (k_infl, v_infl, src) of ``decode_attention_steps``, whose
    tables carry the steps' axis first."""
    what = "decode_attention" if infl is None else "decode_attention_steps"
    if q_rot.dim() != 4 or k_cache.dim() != 4:
        raise ValueError(f"{what}: q_rot and the cache must be 4-D")
    B, S, NH, Dh = q_rot.shape
    Wp, KVH = k_cache.shape[1], k_cache.shape[2]
    steps = () if infl is None else (infl[2].shape[0],)
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {Dh} not in {HEAD_DIMS}")
    if q_rot.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: q dtype {q_rot.dtype} not supported")
    kv_ok = (torch.float32, torch.bfloat16) if q_rot.dtype == torch.float32 else (q_rot.dtype,)
    if infl is None:
        kv_ok += (torch.int8,)
    if k_cache.dtype not in kv_ok or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"{what}: cache dtype {k_cache.dtype} with q {q_rot.dtype} not "
                         f"supported")
    if (k_cache.dtype == torch.int8) != (kv_scales is not None):
        raise ValueError(f"{what}: kv_scales go with an int8 cache, and only there")
    if NH % KVH:
        raise ValueError(f"{what}: {NH} heads over {KVH} kv heads")
    if steps and (steps[0] < 1 or S % steps[0]):
        raise ValueError(f"{what}: {S} rows are not {steps[0]} steps of equal rows")
    if B * KVH * (steps[0] if steps else 1) > 65535:
        raise ValueError(f"{what}: B * KVH * steps exceeds the kernel's grid")
    want = {
        "k_cache": (k_cache, (B, Wp, KVH, Dh), None),
        "v_cache": (v_cache, (B, Wp, KVH, Dh), None),
        "cos": (cos, (*steps, B, Wp, Dh), torch.float32),
        "sin": (sin, (*steps, B, Wp, Dh), torch.float32),
        "order": (order, (*steps, B, Wp), torch.int32),
        "g": (g, (B, S), torch.int32),
        "q_rot": (q_rot, (B, S, NH, Dh), None),
    }
    if kv_scales is not None:
        want["k_scale"] = (kv_scales[0], (B, Wp, KVH), torch.float32)
        want["v_scale"] = (kv_scales[1], (B, Wp, KVH), torch.float32)
    if infl is not None:
        want["k_infl"] = (infl[0], (B, S, KVH, Dh), k_cache.dtype)
        want["v_infl"] = (infl[1], (B, S, KVH, Dh), k_cache.dtype)
        want["src"] = (infl[2], (*steps, B, Wp), torch.int32)
    # 16-byte vector loads and copies where the tensor-core path reads whole rows
    vector = ("q_rot", "k_cache", "v_cache", "cos", "sin", "k_infl", "v_infl")
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != {shape}")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{what}: {name} dtype {t.dtype} != {dtype}")
        if t.device != q_rot.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on {q_rot.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % (4 * t.element_size()) or (name in vector and t.data_ptr() % 16):
            raise ValueError(f"{what}: {name} must start 16-byte and 4-element aligned")


@functools.lru_cache(maxsize=None)
def _scratch_bytes(B, S, NH, KVH, Dh, Wp, kv_dtype, path, splits, steps=1) -> int:
    """Bytes of scratch of a launch of ``steps`` steps of S rows (one: a write pass)."""
    lib = _build.library()
    n = lib.aha_decode_attention_steps_scratch_bytes(B, S, steps, NH, KVH, Dh, Wp,
                                                     _DTYPES[kv_dtype], path, splits)
    if n < 0:
        raise ValueError(f"decode_attention: no scratch size for "
                         f"{(B, S, steps, NH, KVH, Dh, Wp)}")
    return n


def decode_attention(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales=None):
    """Same contract as ``decode_attention_plain``."""
    if q_rot.device.type == "cpu":
        return decode_attention_plain(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales)
    if q_rot.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q_rot.device}")
    _check(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales)
    B, S, NH, Dh = q_rot.shape
    Wp, KVH = k_cache.shape[1], k_cache.shape[2]
    pl = plan(B, S, NH, KVH, Dh, Wp, q_rot.dtype, k_cache.dtype,
              sms=num_sms(q_rot.device.index or 0))
    out = launch_plan(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales, pl=pl)
    LAUNCHES["decode_attention"] += 1
    PATH_LAUNCHES[f"decode_attention/{PATH_NAMES[pl.path]}/{_SHORT[q_rot.dtype]}-"
                  f"{_SHORT[k_cache.dtype]}"] += 1
    return out


def plan_steps(steps: int, B: int, N: int, NH: int, KVH: int, Dh: int, Wp: int,
               q_dtype: torch.dtype, kv_dtype: torch.dtype, *, sms: int = 132) -> Plan:
    """The plan of each step of ``decode_attention_steps`` over N = ``steps`` x
    S rows: the write pass's ``plan`` of S rows, path, tiles and splits alike,
    so that each step's rows sum in its write pass's order (the launch holds
    ``steps`` x ``blocks`` attention blocks)."""
    if steps < 1 or N % steps:
        raise ValueError(f"decode_attention_steps: {N} rows are not {steps} equal steps")
    return plan(B, N // steps, NH, KVH, Dh, Wp, q_dtype, kv_dtype, sms=sms)


def overlaid(k_cache, v_cache, k_infl, v_infl, src):
    """One step's cache as its write pass sees it: slot w of row b holds
    in-flight row ``src[b, w]`` where that is >= 0, else the cache's own
    (a copy; the cache is not written)."""
    take = (src >= 0)[..., None, None]
    idx = src.clamp(min=0).long()
    bidx = torch.arange(src.shape[0], device=src.device)[:, None]
    return (torch.where(take, k_infl[bidx, idx], k_cache),
            torch.where(take, v_infl[bidx, idx], v_cache))


def decode_attention_steps_plain(q_rot, k_cache, v_cache, k_infl, v_infl, cos, sin, order, g,
                                 src, *, attend=decode_attention_plain):
    """The steps one after another, each through ``attend`` (the plain
    version; ``decode_attention_split_plain`` with the step's plan for the
    kernels' arithmetic) over its ``overlaid`` copy of the cache: the
    contract of ``decode_attention_steps``."""
    steps = src.shape[0]
    S = q_rot.shape[1] // steps
    out = []
    for j in range(steps):
        rows = slice(j * S, (j + 1) * S)
        k_j, v_j = overlaid(k_cache, v_cache, k_infl, v_infl, src[j])
        out.append(attend(q_rot[:, rows], k_j, v_j, cos[j], sin[j], order[j], g[:, rows]))
    return torch.cat(out, dim=1)


def decode_attention_steps(q_rot, k_cache, v_cache, k_infl, v_infl, cos, sin, order, g, src):
    """The verify pass's attention in one launch: q_rot [B, N, NH, Dh], N =
    n steps x S rows, rotated at the write positions; one layer's cache
    [B, Wp, KVH, Dh] (bf16 or f32, keys pre-rotated), READ-ONLY; k_infl /
    v_infl [B, N, KVH, Dh] the in-flight rows in the cache's dtype (keys
    pre-rotated); the steps' tables stacked: cos / sin [n, B, Wp, Dh] f32,
    order [n, B, Wp] int32, g [B, N] int32; src [n, B, Wp] int32, the
    in-flight row slot w of row b holds in step j's write pass, or -1 for the
    cache's own. Step j's rows are ``decode_attention`` of them over that
    cache, bit for bit (the same kernels, plan and order of sums). Returns
    [B, N, NH, Dh] in q's dtype."""
    if q_rot.device.type == "cpu":
        return decode_attention_steps_plain(q_rot, k_cache, v_cache, k_infl, v_infl, cos, sin,
                                            order, g, src)
    if q_rot.device.type != "cuda":
        raise ValueError(f"decode_attention_steps: unsupported device {q_rot.device}")
    _check(q_rot, k_cache, v_cache, cos, sin, order, g, None, infl=(k_infl, v_infl, src))
    B, N, NH, Dh = q_rot.shape
    Wp, KVH = k_cache.shape[1], k_cache.shape[2]
    steps = src.shape[0]
    pl = plan_steps(steps, B, N, NH, KVH, Dh, Wp, q_rot.dtype, k_cache.dtype,
                    sms=num_sms(q_rot.device.index or 0))
    out = launch_plan(q_rot, k_cache, v_cache, cos, sin, order, g, pl=pl,
                      infl=(k_infl, v_infl, src))
    LAUNCHES["decode_attention_steps"] += 1
    PATH_LAUNCHES[f"decode_attention_steps/{PATH_NAMES[pl.path]}/{_SHORT[q_rot.dtype]}-"
                  f"{_SHORT[k_cache.dtype]}"] += 1
    return out


def launch_plan(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales=None, *, pl: Plan,
                infl=None):
    """The kernels of ``pl`` on CUDA tensors that ``_check`` admits, uncounted
    (``decode_attention`` and ``decode_attention_steps`` count their own
    launches): ``chip_smoke.py`` times the plan a path replaced through it.
    ``infl``: (k_infl, v_infl, src) of ``decode_attention_steps``, ``pl``
    each step's plan. Raises where the plan's path does not take the
    operands' types or shapes."""
    B, N, NH, Dh = q_rot.shape
    Wp, KVH = k_cache.shape[1], k_cache.shape[2]
    steps = 1 if infl is None else infl[2].shape[0]
    S = N // steps
    out = torch.empty_like(q_rot)
    nbytes = _scratch_bytes(B, S, NH, KVH, Dh, Wp, k_cache.dtype, pl.path, pl.splits, steps)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=q_rot.device) if nbytes else None
    ks, vs = (None, None) if kv_scales is None else (kv_scales[0].data_ptr(),
                                                     kv_scales[1].data_ptr())
    tail = (None if scratch is None else scratch.data_ptr(), B, S)
    lib = _build.library()
    if infl is None:
        entry, what, head = lib.aha_decode_attention, "decode_attention", ()
    else:
        entry, what = lib.aha_decode_attention_steps, "decode_attention_steps"
        head, tail = tuple(t.data_ptr() for t in infl), tail + (steps,)
    err = entry(
        q_rot.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), *head, cos.data_ptr(),
        sin.data_ptr(), order.data_ptr(), g.data_ptr(), ks, vs, out.data_ptr(), *tail,
        NH, KVH, Dh, Wp, _DTYPES[q_rot.dtype], _DTYPES[k_cache.dtype],
        1.0 / math.sqrt(Dh), pl.path, pl.span, pl.splits,
        ctypes.c_void_p(torch.cuda.current_stream(q_rot.device).cuda_stream))
    _build.check(lib, err, what)
    return out
