"""Port parity: the check layout's lane-tiled state (csrc/minsum.cu "Lane
tiles"; ops/minsum.py ``tile_lanes``).

  * ``tile_lanes`` / ``untile_lanes`` round-trip every per-lane shape the
    kernels take, ragged batches padded with the fill value.
  * The tiled plain versions (``check_update_ref``, ``check_iter_ref``,
    ``var_iter_ref`` with ``lane_tile``) are their untiled forms between an
    un-tile and a re-tile: bitwise, float32 and bfloat16, every damping kind
    (negative per-variable strengths among them).
  * ``MinSumDecode(layout="check")`` on 64- and 128-lane tiles is bitwise
    the lane-major decode (``_lane_tile=1``, the CPU's default) on every
    output, for ragged and whole tiles (B = 1, 33, 64), checked every
    iteration and every 8th, with and without ``track_best``, with scalar,
    ``[B]`` and ``[B, n]`` gammas; and on tiles bitwise the JAX package run
    op by op, as tests/test_torch_minsum_fused.py
    ``test_minsum_decode_matches_reference_op_by_op`` holds the lane-major
    decode (32 records, one ragged tile).
  * The wrappers refuse what the tiled kernels do not take and count no
    launch on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.models.minsum import make_minsum_decode_fn
from ldpcdecoders_tpu_torch.models import minsum as minsum_module
from ldpcdecoders_tpu_torch.models.minsum import lane_tile_for
from ldpcdecoders_tpu_torch.ops import cuda_minsum
from ldpcdecoders_tpu_torch.ops.minsum import (
    check_iter_ref,
    check_update_ref,
    gather_lanes_ref,
    tile_lanes,
    untile_lanes,
    var_iter_ref,
)

torch.set_num_threads(1)


def small_dem(seed=5, D=40, N=300):
    """tests/test_torch_staged.py's ``_small_dem(5)``: checks past 32 slots,
    variables of degree up to 40 (summed by windows of 32)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((D, N)) < 0.08).astype(np.uint8)
    A[:, A.sum(axis=0) == 0] = 1
    pr = np.clip(rng.random(N) * 0.01, 1e-4, 0.01)
    return A, pr


def bits(t):
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16)
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


def gamma_of(kind, B, n, dtype, seed=11):
    rng = np.random.default_rng(seed)
    if kind is None:
        return None
    g = {"scalar": np.float32(0.4), "lane": rng.uniform(-0.2, 0.7, B),
         "var": rng.uniform(-0.24, 0.66, (B, n))}[kind]
    return torch.as_tensor(np.asarray(g, np.float32)).to(dtype)


@pytest.mark.parametrize("B", [1, 31, 32, 33, 70])
@pytest.mark.parametrize("lane_tile", [1, 32, 64, 128])
@pytest.mark.parametrize("rest", [(), (7,), (3, 5)])
def test_tile_lanes_round_trip(B, lane_tile, rest):
    x = torch.arange(B * int(np.prod(rest, dtype=int)), dtype=torch.float32).reshape(B, *rest)
    t = tile_lanes(x, lane_tile, fill=-1)
    if lane_tile == 1:
        assert t is x and untile_lanes(t, 1) is t
        return
    bt = -(-B // lane_tile)
    assert t.shape == (bt, *rest, lane_tile) and t.is_contiguous()
    back = untile_lanes(t, lane_tile)
    assert back.shape == (bt * lane_tile, *rest)
    assert torch.equal(back[:B], x) and bool((back[B:] == -1).all())
    # lane b's entry sits at [b // T, ..., b % T]
    b = B - 1
    assert torch.equal(t[b // lane_tile, ..., b % lane_tile], x[b])


@pytest.mark.parametrize("tiles", [(1, 64), (64, 1), (128, 64), (64, 128), (128, 128)])
@pytest.mark.parametrize("rest", [(), (7,), (3, 5)])
def test_gather_lanes_between_tilings(tiles, rest):
    """``gather_lanes_ref`` takes the listed lanes (reordered, repeated) of
    a tiled tensor into another tiling: its untiled form is those lanes'
    rows, bitwise."""
    T, T2 = tiles
    B, k = 300, 2 * T2 if T2 > 1 else 7
    x = torch.randn(B, *rest)
    lanes = torch.as_tensor(np.random.default_rng(T + T2).permutation(B)[:k - 3])
    lanes = torch.cat([lanes, lanes[:1].expand(3)])
    got = gather_lanes_ref(tile_lanes(x, T), T, T2, lanes)
    assert got.shape == ((2, *rest, T2) if T2 > 1 else (k, *rest)) and got.is_contiguous()
    assert torch.equal(untile_lanes(got, T2), x[lanes])


def setup(dtype, B, seed=4):
    A, pr = small_dem()
    g = pt.TannerGraph.from_pcm(A)
    ms = pt.MinSumDecode(g, 0.05, 2, device="cpu", dtype=dtype, layout="check", alpha=0.8)
    rng = np.random.default_rng(seed)
    x = rng.random((B, g.n)) < pr * 8
    syn = torch.as_tensor(((x.astype(np.int64) @ A.T) % 2).astype(bool))
    return g, ms, syn, rng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gamma_kind", [None, "scalar", "lane", "var"])
@pytest.mark.parametrize("lane_tile", [64, 128])
def test_tiled_plain_versions_are_the_untiled_ones(dtype, gamma_kind, lane_tile):
    """K3's two forms and K4's iteration form on tiled state, bitwise their
    lane-major forms on the same lanes (a whole tile and a ragged one)."""
    T = lane_tile
    B = T + 5  # lanes past the first tile: the second is ragged
    g, ms, syn, rng = setup(dtype, -(-B // T) * T)
    Bp, dc, m, n = syn.shape[0], g.max_dc, g.m, g.n
    L0 = torch.as_tensor(rng.normal(size=(Bp, n)) * 3).to(dtype)
    mu = torch.as_tensor(rng.normal(size=(Bp, dc, m)) * 2).to(dtype)
    nu = torch.as_tensor(rng.normal(size=(Bp, dc, m)) * 3).to(dtype)
    total = torch.as_tensor(rng.normal(size=(Bp, n)) * 4).to(dtype)
    gamma = gamma_of(gamma_kind, Bp, n, dtype)
    tile = lambda t: t if t is None or t.ndim == 0 else tile_lanes(t, T)  # noqa: E731
    args = (ms.chk_mask, 0.8125, 0.15625)

    want = check_update_ref(L0, ms.chk_varidx, syn, *args)
    got = check_update_ref(tile(L0), ms.chk_varidx, tile(syn), *args, lane_tile=T)
    assert got.shape == (Bp // T, dc, m, T)
    assert torch.equal(bits(untile_lanes(got, T)), bits(want))

    mu_w, nu_w = mu.clone(), None if gamma is None else nu.clone()
    check_iter_ref(mu_w, total, ms.chk_varidx, syn, *args, gamma, nu_w)
    mu_t, nu_t = tile(mu), None if gamma is None else tile(nu)
    assert check_iter_ref(mu_t, tile(total), ms.chk_varidx, tile(syn), *args, tile(gamma),
                          nu_t, lane_tile=T) is mu_t
    assert torch.equal(bits(untile_lanes(mu_t, T)), bits(mu_w))
    if gamma is not None:
        assert torch.equal(bits(untile_lanes(nu_t, T)), bits(nu_w))

    mu_flat = mu_w.reshape(Bp, -1)
    done = torch.as_tensor(rng.random(Bp) < 0.4)
    err0 = torch.as_tensor((rng.random((Bp, n)) < 0.5).astype(np.float32))
    llr0 = torch.as_tensor(rng.normal(size=(Bp, n))).to(dtype)
    tot_w, err_w, llr_w = torch.empty_like(L0), err0.clone(), llr0.clone()
    var_iter_ref(mu_flat, ms.v2c, ms.var_mask, L0, total=tot_w, done=done, err=err_w,
                 llrs=llr_w)
    tot_t, err_t, llr_t = tile(torch.empty_like(L0)), tile(err0), tile(llr0)
    assert var_iter_ref(tile(mu_flat), ms.v2c, ms.var_mask, tile(L0), total=tot_t,
                        done=tile(done), err=err_t, llrs=llr_t, lane_tile=T) is tot_t
    for a, b in ((tot_t, tot_w), (err_t, err_w), (llr_t, llr_w)):
        assert torch.equal(bits(untile_lanes(a, T)), bits(b))


# the staged decoder's inner decodes (models/staged.py) and two more gamma forms
DECODES = {
    "stage0": (dict(damping=0.4), None, torch.float32),
    "stage0_track_best": (dict(damping=0.4, track_best=True), None, torch.float32),
    "deep": (dict(lane_damping=True, track_best=True), "var", torch.bfloat16),
    "deep_lane_gamma": (dict(lane_damping=True, track_best=True), "lane", torch.float32),
    "undamped_bf16": (dict(), None, torch.bfloat16),
}


@pytest.mark.parametrize("name", list(DECODES))
@pytest.mark.parametrize("B", [1, 33, 64])
@pytest.mark.parametrize("check_every", [1, 8])
def test_tiled_decode_equals_lane_major(name, B, check_every):
    """16 iterations on the small DEM: every output of the tiled decodes
    (64- and 128-lane tiles) bitwise the lane-major one's."""
    kw, gamma_kind, dtype = DECODES[name]
    A, pr = small_dem()
    g = pt.TannerGraph.from_pcm(A)
    rng = np.random.default_rng(B)
    x = rng.random((B, g.n)) < pr * 4
    syn = torch.as_tensor(((x.astype(np.int64) @ A.T) % 2).astype(np.uint8))
    gamma = gamma_of(gamma_kind, B, g.n, torch.float32, seed=B)
    outs = {}
    for T in (1, 64, 128):
        mod = pt.MinSumDecode(g, pr, 16, device="cpu", dtype=dtype, layout="check",
                              check_every=check_every, _lane_tile=T, **kw)
        outs[T] = mod(syn, None, gamma)
    for T in (64, 128):
        for a, b in zip(outs[1], outs[T]):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(bits(a), bits(b))
    if B == 64:
        conv = outs[1][1]
        assert conv.any() and not conv.all(), "the case needs lanes on both sides"


@pytest.mark.parametrize("B,want", [(0, 1), (1, 1), (32, 1), (63, 1), (64, 64), (65, 128),
                                    (96, 128), (127, 128), (128, 128), (192, 64), (320, 64),
                                    (1536, 128), (2048, 128)])
def test_lane_tile_for(B, want):
    """The tile that pads the batch least, the largest on a tie; lane-major
    below 64 lanes."""
    assert lane_tile_for(B) == want


@pytest.mark.parametrize("B,want", [(1, 1), (16, 1), (20, 1), (21, 64), (48, 64), (63, 64),
                                    (64, 64), (200, 128), (2048, 128)])
def test_var_layout_tiles_where_its_messages_outgrow_l2(monkeypatch, B, want):
    """On a card the variable layout is lane-major while its lanes'
    messages (a row of nu and one of mu each, in the message dtype) fit the
    card's L2, and past that takes lane_tile_for's tile, 64 lanes below 64;
    the check layout keeps lane_tile_for; the CPU stays lane-major.  The L2
    here holds 20 float32 lanes (40 in bfloat16)."""
    A, pr = small_dem()
    g = pt.TannerGraph.from_pcm(A)
    card, cpu = torch.device("cuda"), torch.device("cpu")
    row = (g.max_dv * g.n + g.max_dc * g.m) * 4
    monkeypatch.setattr(minsum_module, "_l2_bytes", lambda device: 20 * row)
    var = pt.MinSumDecode(g, pr, 2, device="cpu")
    var16 = pt.MinSumDecode(g, pr, 2, device="cpu", dtype=torch.bfloat16)
    check = pt.MinSumDecode(g, pr, 2, device="cpu", layout="check")
    assert var._tile(B, card) == want and var._tile(B, cpu) == 1
    assert var16._tile(B, card) == (1 if B <= 40 else want)
    assert check._tile(B, card) == lane_tile_for(B)


def test_var_layout_stays_lane_major(monkeypatch):
    """The variable layout stays lane-major on the CPU at any batch, as the
    check layout does; a forced tile tiles its state (a card picks the tile
    by batch in both layouts: tests/test_torch_cuda.py)."""
    A, pr = small_dem()
    g = pt.TannerGraph.from_pcm(A)
    mod = pt.MinSumDecode(g, pr, 4, device="cpu")
    assert mod._lane_tile is None and mod._tile(2048, torch.device("cpu")) == 1
    seen = []
    real = minsum_module.tile_lanes
    monkeypatch.setattr(minsum_module, "tile_lanes",
                        lambda x, T, *a: seen.append(T) or real(x, T, *a))
    syn = torch.zeros((128, g.m), dtype=torch.uint8)
    mod(syn)
    assert seen and set(seen) == {1}
    seen.clear()
    pt.MinSumDecode(g, pr, 2, device="cpu", _lane_tile=64)(syn)
    assert seen and set(seen) == {64}


def test_cpu_decode_stays_lane_major(monkeypatch):
    """On the CPU the check layout's default is lane-major at any batch (the
    plain versions gain nothing from tiles); a forced tile still tiles."""
    A, pr = small_dem()
    g = pt.TannerGraph.from_pcm(A)
    seen = []
    real = minsum_module.tile_lanes
    monkeypatch.setattr(minsum_module, "tile_lanes",
                        lambda x, T, *a: seen.append(T) or real(x, T, *a))
    syn = torch.zeros((128, g.m), dtype=torch.uint8)
    pt.MinSumDecode(g, pr, 2, device="cpu", layout="check")(syn)
    assert seen and set(seen) == {1}
    seen.clear()
    pt.MinSumDecode(g, pr, 2, device="cpu", layout="check", _lane_tile=128)(syn)
    assert seen and set(seen) == {128}


# tests/test_torch_minsum_fused.py's witness configurations
WITNESS = {
    "stage0": (dict(layout="check", damping=0.4, check_every=8), None, torch.float32, 8),
    "stage0_track_best": (dict(layout="check", damping=0.4, check_every=8, track_best=True),
                          None, torch.float32, 8),
    "deep": (dict(layout="check", lane_damping=True, track_best=True, check_every=8), "var",
             torch.bfloat16, 4),
    "deep_lane_gamma": (dict(layout="check", lane_damping=True, track_best=True,
                             check_every=8), "lane", torch.float32, 4),
}
JNP_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.mark.parametrize("name", list(WITNESS))
def test_tiled_decode_matches_reference_op_by_op(name):
    """12 iterations on the small DEM, 32 records on one ragged 64-lane tile:
    the tiled decode bitwise against the JAX package run op by op."""
    kw, gamma_kind, dtype, scale = WITNESS[name]
    A, pr = small_dem()
    B = 32
    rng = np.random.default_rng(1)
    x = rng.random((B, A.shape[1])) < pr * scale
    syn = ((x.astype(np.int64) @ A.T) % 2).astype(np.uint8)
    gamma = gamma_of(gamma_kind, B, A.shape[1], torch.float32)
    gref = lt.TannerGraph.from_pcm(A)
    fn = make_minsum_decode_fn(gref, pr, 12, dtype=JNP_DTYPE[dtype], **kw)
    args = [jnp.asarray(syn), None] + ([] if gamma is None else [jnp.asarray(gamma.numpy())])
    with jax.disable_jit():
        want = fn(*args)
    mod = pt.MinSumDecode(pt.TannerGraph.from_arrays(**dataclasses.asdict(gref)), pr, 12,
                          device="cpu", dtype=dtype, _lane_tile=64, **kw)
    got = mod(torch.as_tensor(syn), None, gamma)
    for a, b in zip(want[:3], got[:3]):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert np.array_equal(np.asarray(want[3]).astype(np.float32).view(np.uint32),
                          got[3].to(torch.float32).numpy().view(np.uint32))
    conv = np.asarray(want[1])
    assert conv.any() and not conv.all(), "the case needs lanes on both sides"


def test_tiled_wrappers_refuse_what_the_kernels_do_not_take():
    g, ms, syn, rng = setup(torch.float32, 64)
    n, dc, m = g.n, g.max_dc, g.m
    L0 = tile_lanes(torch.zeros((64, n)), 64)
    mu = torch.zeros((1, dc, m, 64))
    before = {w: dict(w.routes) for w in (cuda_minsum.minsum_check_cuda,
                                          cuda_minsum.minsum_check_iter_cuda,
                                          cuda_minsum.minsum_var_iter_cuda)}
    with pytest.raises(ValueError, match="lane_tile must be"):
        cuda_minsum.minsum_check_cuda(L0, ms.chk_varidx, tile_lanes(syn, 64), ms.chk_mask, 1.0,
                                      0.0, lane_tile=32)
    with pytest.raises(ValueError, match="gathered form"):
        cuda_minsum.minsum_check_cuda(mu, None, tile_lanes(syn, 64), ms.chk_mask, 1.0, 0.0,
                                      lane_tile=64)
    with pytest.raises(ValueError, match="lane-tiled"):
        cuda_minsum.minsum_check_iter_cuda(mu[..., 0], L0, ms.chk_varidx, tile_lanes(syn, 64),
                                           ms.chk_mask, 1.0, 0.0, lane_tile=64)
    with pytest.raises(ValueError, match="W with nu only"):
        cuda_minsum.minsum_var_iter_cuda(mu.reshape(1, dc * m, 64), ms.v2c, ms.var_mask, L0,
                                         W=torch.ones((g.max_dv, n)), lane_tile=64)
    with pytest.raises(ValueError, match="lane-tiled"):
        cuda_minsum.minsum_var_iter_cuda(mu.reshape(dc * m, 64), ms.v2c, ms.var_mask, L0,
                                         lane_tile=64)
    # the CPU runs the plain versions and counts no launch
    total = torch.empty_like(L0)
    cuda_minsum.minsum_var_iter_cuda(mu.reshape(1, dc * m, 64), ms.v2c, ms.var_mask, L0,
                                     total=total, lane_tile=64)
    cuda_minsum.minsum_check_iter_cuda(mu, total, ms.chk_varidx, tile_lanes(syn, 64),
                                       ms.chk_mask, 1.0, 0.0, lane_tile=64)
    for w, routes in before.items():
        assert w.routes == routes


@pytest.mark.parametrize("dtype,lane_tile,want", [(torch.bfloat16, 64, True),
                                                  (torch.bfloat16, 128, True),
                                                  (torch.bfloat16, 1, False),
                                                  (torch.float32, 64, False),
                                                  (torch.float32, 128, False)])
def test_packed_check_body_takes_bfloat16_on_tiles(dtype, lane_tile, want):
    """K3's packed body takes the bfloat16 launches on a lane tile and no
    other, and refuses per-lane tensors off its vectors of T / 32 lanes;
    None and 0-dim arguments are not per-lane.  The CPU's plain versions
    count no packed lane-iteration."""
    from ldpcdecoders_tpu_torch.utils import profiling

    x = torch.zeros(256, dtype=dtype)
    assert cuda_minsum._packed(dtype, lane_tile, x, None, torch.tensor(0.5)) is want
    if want:
        with pytest.raises(ValueError, match="aligned"):
            cuda_minsum._packed(dtype, lane_tile, x, x[1:])
    else:
        assert cuda_minsum._packed(dtype, lane_tile, x[1:]) is False
    T = max(lane_tile, 64)
    g, ms, syn, _ = setup(dtype, T)
    mu = torch.zeros((1, g.max_dc, g.m, T), dtype=dtype)
    total = torch.zeros((1, g.n, T), dtype=dtype)
    with profiling.recording() as rec:
        cuda_minsum.minsum_check_iter_cuda(mu, total, ms.chk_varidx, tile_lanes(syn, T),
                                           ms.chk_mask, 1.0, 0.0, lane_tile=T)
    assert "minsum_check_lane_iters_packed" not in rec.counters
