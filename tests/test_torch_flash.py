"""K8's two routes on the CPU: which route a call takes, and the
arithmetic of the tensor-core route.

* ``_route`` on CPU tensors of each shape class and stride pattern the
  card's cases use (broadcast views among them), and on views that TMA
  cannot take (a misaligned base pointer, a stride that is not a multiple
  of 16 bytes);
* the wrapper's launch path with its C entry points replaced: a refused
  launch raises and counts nothing, and the SIMT route is never tried in
  its place;
* the tensor-core route's numerics, emulated with torch casts (64-key
  tiles, p carried as bf16 ``p_hi + p_lo``, fp32 sums) against the plain
  twin and against the reference's Pallas kernel in interpret mode.

The kernels themselves run only on the card (``tests/test_torch_gpu.py``).
"""

import _torch_threads  # noqa: F401  (first: a worker's share of the cores)
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import flash_attention as fa

BF16 = torch.bfloat16
#: K8 against its twin in bf16 (chip_smoke.py's FLASH_TOL): the output's
#: one rounding
FLASH_TOL = dict(rtol=2 ** -7, atol=1e-5)


def _qkv(b, s, t, h, hk, dh, dv, dtype=BF16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype) for shape in
        ((b, s, h, dh), (b, t, hk, dh), (b, t, hk, dv)))


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------

def _strided(shape, strides, offset=0, dtype=BF16):
    base = torch.zeros(offset + sum((n - 1) * st for n, st in
                                    zip(shape, strides)) + 1, dtype=dtype)
    return torch.as_strided(base, shape, strides, offset)


ROUTE_CASES = {
    # the card's cases, contiguous
    "qwen_heads": (_qkv(1, 70, 70, 16, 2, 128, 128), "wgmma"),
    "internvl2-1b_heads": (_qkv(1, 70, 70, 14, 2, 64, 64), "wgmma"),
    "cross": (_qkv(2, 10, 15, 4, 4, 64, 64), "wgmma"),
    "dv_lt_dh": (_qkv(1, 33, 33, 2, 1, 64, 32), "wgmma"),
    "dh_16": (_qkv(1, 8, 8, 2, 2, 16, 16), "wgmma"),
    "dh_256": (_qkv(1, 8, 8, 2, 1, 256, 256), "wgmma"),
    "fp32": (_qkv(1, 70, 70, 16, 2, 128, 128, torch.float32), "simt"),
    "dh_8": (_qkv(1, 8, 8, 2, 2, 8, 8), "simt"),
    "dh_24": (_qkv(1, 8, 8, 2, 2, 24, 24), "simt"),
    "dv_40": (_qkv(1, 8, 8, 2, 2, 64, 40), "simt"),
    # (B, H, S, dh) storage read through its strides: no copy needed
    "heads_major": (tuple(x.transpose(1, 2).contiguous().transpose(1, 2)
                          for x in _qkv(2, 40, 40, 4, 2, 64, 64)), "wgmma"),
    # a base pointer 2 bytes off 16
    "misaligned_base": ((_strided((1, 8, 2, 64), (1152, 144, 72, 1), 1),)
                        * 3, "simt"),
    # a head stride of 68 elements (136 bytes)
    "misaligned_stride": ((_strided((1, 8, 2, 64), (1088, 136, 68, 1)),)
                          * 3, "simt"),
    # only v misaligned
    "misaligned_v": (_qkv(1, 8, 8, 2, 2, 64, 64)[:2]
                     + (_strided((1, 8, 2, 64), (1152, 144, 72, 1), 1),),
                     "simt"),
    # a dim of size 1 is never stepped: its stride does not matter
    "size_one_batch": ((_strided((1, 8, 2, 64), (3, 128, 64, 1)),) * 3,
                       "wgmma"),
    # broadcast views: stride 0 is a multiple of 16 bytes too
    "broadcast": ((_strided((3, 8, 4, 64), (512, 64, 0, 1)),)
                  + (_strided((3, 8, 2, 64), (0, 128, 64, 1)),) * 2,
                  "wgmma"),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route(case):
    (q, k, v), want = ROUTE_CASES[case]
    fa._check(q, k, v, 512, 512)   # every case is a call the kernel takes
    assert fa._route(q, k, v) == want


def test_routes_are_the_counted_ones():
    assert tuple(fa.flash_attention.launches_by_route) == fa.ROUTES
    before = dict(fa.flash_attention.launches_by_route)
    q, k, v = _qkv(1, 8, 8, 2, 2, 16, 16)
    fa.flash_attention(q, k, v)          # CPU: the twin, no launch
    assert fa.flash_attention.launches_by_route == before


# --------------------------------------------------------------------------
# the launch path, with the C entry points replaced
# --------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """Send CPU tensors down the wrapper's CUDA branch; ``calls`` records
    which entry point ran, ``result`` sets what each returns."""
    calls, result = [], {"wgmma": 0, "simt": 0}

    def entry(route):
        def fn(*args):
            calls.append(route)
            return result[route]
        return fn
    monkeypatch.setattr(fa._build, "dispatch_device", lambda x: "cuda")
    monkeypatch.setattr(fa, "_entry", entry)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return calls, result


@pytest.mark.parametrize("dtype,route", [(BF16, "wgmma"),
                                         (torch.float32, "simt")])
def test_launch_counts_by_route(fake_card, dtype, route):
    calls, _ = fake_card
    q, k, v = _qkv(1, 8, 8, 4, 2, 16, 16, dtype)
    total = fa.flash_attention.launches
    before = dict(fa.flash_attention.launches_by_route)
    out = fa.flash_attention(q, k, v)
    assert out.shape == (1, 8, 64) and out.dtype == dtype
    assert calls == [route]
    assert fa.flash_attention.launches == total + 1
    want = dict(before)
    want[route] += 1
    assert fa.flash_attention.launches_by_route == want


@pytest.mark.parametrize("code", [1000, 2001, 700])
def test_a_refused_tensor_core_launch_raises(fake_card, code):
    """No encoder (1000), a refused tensor map (2000 + CUresult) or a CUDA
    error: the wrapper raises, counts nothing and never tries the SIMT
    route in its place."""
    calls, result = fake_card
    result["wgmma"] = code
    q, k, v = _qkv(1, 8, 8, 4, 2, 16, 16)
    total = fa.flash_attention.launches
    before = dict(fa.flash_attention.launches_by_route)
    with pytest.raises(RuntimeError, match="wgmma"):
        fa.flash_attention(q, k, v)
    assert calls == ["wgmma"]
    assert fa.flash_attention.launches == total
    assert fa.flash_attention.launches_by_route == before


# --------------------------------------------------------------------------
# the tensor-core route's arithmetic, emulated
# --------------------------------------------------------------------------

def _emulate_tc(q, k, v, causal, split=True):
    """The tensor-core route's arithmetic in torch, before the output's
    rounding: 64-key tiles, bf16 products summed in fp32, the scale after
    the product, online softmax in fp32 with ``expf``, and P V with p as
    ``p_hi + p_lo`` (``split``) or rounded once to bf16 (not ``split``).
    Tiles wholly above the diagonal are computed, not skipped: there p is
    0 and corr 1 exactly, so the result is the same."""
    b, s, h, dh = q.shape
    t, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    group = h // hk
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(group, 1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(group, 1)
    scale = fa._scale(dh)
    q_pos = torch.arange(s)[:, None]
    m = torch.full((b, h, s), fa.NEG_INF)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, dv))
    for k0 in range(0, t, 64):
        sc = torch.matmul(qf, kf[:, :, k0:k0 + 64].transpose(-1, -2)) * scale
        kv_pos = k0 + torch.arange(sc.shape[-1])[None, :]
        valid = kv_pos < t
        if causal:
            valid = valid & (q_pos >= kv_pos)
        sc = torch.where(valid, sc, fa.NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        vt = vf[:, :, k0:k0 + 64]
        p_hi = p.to(BF16).float()
        acc = acc * corr[..., None] + torch.matmul(p_hi, vt)
        if split:
            acc = acc + torch.matmul((p - p_hi).to(BF16).float(), vt)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 2, 1, 3).reshape(b, s, h * dv)


#: qwen2.5-3b's head layout, narrow: 16 query heads over 2, dh 128, a
#: ragged length (the tail tile masked)
SPLIT_CASE = (1, 150, 150, 16, 2, 128, 128)


@pytest.mark.parametrize("causal", [True, False])
def test_split_p_stays_within_the_twin_tolerance(causal):
    """The emulated route, rounded to bf16, is within FLASH_TOL of the twin
    (measured: at most one bf16 ulp apart, max abs error 0.0039 causal and
    0.0020 not, with outputs up to 2.8 and 1.1)."""
    q, k, v = _qkv(*SPLIT_CASE, seed=3)
    got = _emulate_tc(q, k, v, causal).to(BF16)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_split_p_keeps_p_to_16_bits(causal):
    """Before the output's rounding the emulated route differs from the
    twin by 2^-16 of the output's largest value at most (measured: 2^-19.2
    causal, 2^-19.3 not; p_hi + p_lo keeps p to about 2^-17 relative),
    while rounding p once to bf16 costs 2^-9.4 and 2^-9.8, more than a bf16
    ulp of the output's smaller values: without the split the route could
    not hold FLASH_TOL."""
    q, k, v = _qkv(*SPLIT_CASE, seed=3)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal)
    top = float(want.abs().max())
    err_split = float((_emulate_tc(q, k, v, causal) - want).abs().max())
    err_round = float((_emulate_tc(q, k, v, causal, split=False)
                       - want).abs().max())
    assert err_split <= 2 ** -16 * top
    assert err_round >= 2 ** -12 * top
    assert err_round >= 16 * err_split


def test_split_p_matches_pallas_bf16():
    """The emulated route against the reference's Pallas kernel itself
    (interpret mode), bf16 in and out: within one bf16 ulp."""
    q, k, v = _qkv(1, 96, 96, 4, 2, 64, 64, seed=5)
    bf = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    ref = ref_flash(bf(q), bf(k), bf(v), q_chunk=32, kv_chunk=32)
    got = _emulate_tc(q, k, v, True).to(BF16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-5)
