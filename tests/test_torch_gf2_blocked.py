"""Port parity: the blocked GF(2) eliminations (``ops/gf2.py``) and the
CUDA launcher's plan (``ops/cuda_gf2.py``), on the CPU.

``gf2_osd0_blocked`` and ``gf2_eliminate_blocked`` compute by panels of
columns, row codes and an XOR table, step for step as ``csrc/gf2_elim.cu``
does.  They are held bitwise (tolerance: none) against the column-by-column
plain versions ``gf2_osd0`` / ``gf2_eliminate`` for panel widths 1, 2, 4, 8,
and once against the reference package's Pallas kernels in interpret mode,
as tests/test_torch_bposd.py runs them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldpcdecoders_tpu.ops.pallas_gf2 import gf2_eliminate_pallas, gf2_osd0_pallas
from ldpcdecoders_tpu_torch.ops import cuda_gf2, gf2

torch.set_num_threads(1)


def pack(H):
    """Dense 0/1 ``[B, m, n]`` -> transposed packed ``Ht [B, W, m]`` int32."""
    B, m, n = H.shape
    W = (n + 31) // 32
    Hpad = np.pad(H.astype(np.int64), ((0, 0), (0, 0), (0, W * 32 - n))).reshape(B, m, W, 32)
    words = (Hpad << np.arange(32)).sum(axis=3)  # [B, m, W] < 2**32
    Ht = np.ascontiguousarray(words.transpose(0, 2, 1)).astype(np.uint32).view(np.int32)
    return torch.as_tensor(Ht)


def random_system(seed, B, m, n, dens):
    rng = np.random.default_rng(seed)
    return rng, (rng.random((B, m, n)) < dens).astype(np.int64)


def sys_random(seed=0):
    """n % 32 != 0, m % 32 != 0."""
    return random_system(seed, 4, 60, 80, 0.3)


def sys_ragged(seed=1):
    """A second word of one column."""
    return random_system(seed, 3, 31, 33, 0.5)


def sys_rank_deficient(seed=2):
    """Duplicate rows, a zero row, dependent rows: columns without a pivot."""
    rng, H = random_system(seed, 3, 40, 100, 0.2)
    H[:, 7] = H[:, 3]
    H[:, 20] = H[:, 3]
    H[:, 11] = 0
    H[:, 30] = H[:, 5] ^ H[:, 6]
    H[1, :, :9] = 0  # a lane whose first panel has no pivot at all
    return rng, H


def sys_all_zero(seed=3):
    rng, H = random_system(seed, 2, 24, 70, 0.3)
    H[0] = 0
    return rng, H


def sys_wide_sparse(seed=4):
    """More words than panels per word can fill: sparse, m << n."""
    return random_system(seed, 2, 96, 240, 0.05)


def sys_tall(seed=5):
    """m > 1024: rows strided over the block in the kernel, m > n."""
    return random_system(seed, 2, 1100, 300, 0.004)


def sys_full_rank_inside_a_panel(seed=6):
    """Identity on columns 3..m+2: full rank is reached in the middle of a
    panel of 8 and of 4; the columns after it must change nothing."""
    rng, H = random_system(seed, 2, 21, 64, 0.4)
    H[0] = 0
    H[0, np.arange(21), np.arange(21) + 3] = 1
    H[0, :, 40:] = rng.random((21, 24)) < 0.5
    return rng, H


SYSTEMS = {f.__name__[4:]: f for f in (sys_random, sys_ragged, sys_rank_deficient, sys_all_zero,
                                       sys_wide_sparse, sys_tall, sys_full_rank_inside_a_panel)}
PANELS = [1, 2, 4, 8]


@pytest.mark.parametrize("panel", PANELS)
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_eliminate_blocked_equals_sequential(name, panel):
    rng, H = SYSTEMS[name]()
    B, m, n = H.shape
    Ht = pack(H)
    s = torch.as_tensor((rng.random((B, m)) < 0.5).astype(np.int32))
    want = gf2.gf2_eliminate(Ht, s, n)
    got = gf2.gf2_eliminate_blocked(Ht, s, n, panel)
    for a, b, what in zip(got, want, ("Ht", "s", "pivcol", "rank")):
        assert a.dtype == b.dtype and torch.equal(a, b), what


@pytest.mark.parametrize("panel", PANELS)
@pytest.mark.parametrize("name", list(SYSTEMS))
def test_osd0_blocked_equals_sequential(name, panel):
    """Residuals inside the row space (the lane stops early), outside it
    (lane 0 runs to the last column) and zero (the last lane never starts)."""
    rng, H = SYSTEMS[name]()
    B, m, n = H.shape
    Ht = pack(H)
    bp = (rng.random((B, n)) < 0.2).astype(np.int32)
    extra = (rng.random((B, n)) < 0.1).astype(np.int64)
    resid = (np.einsum("bmn,bn->bm", H, extra) % 2).astype(np.int32)
    resid[0] = rng.random(m) < 0.5
    resid[-1] = 0
    args = (Ht, torch.as_tensor(resid), torch.as_tensor(bp), n)
    want, (trips, *_) = gf2.gf2_osd0(*args, return_work=True)
    assert int(trips[-1]) == 0
    got = gf2.gf2_osd0_blocked(*args, panel)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("panel", PANELS)
def test_osd0_blocked_lanes_stop_inside_a_panel(panel):
    """Lane b's residual is column b of its system: OSD-0 stops at the entry
    of column b + 1, at every offset of a panel, and must neither record
    nor apply the panel's later pivots."""
    B, m, n = 24, 70, 120
    rng, H = random_system(7, B, m, n, 0.3)
    Ht = pack(H)
    resid = torch.as_tensor(np.stack([H[b, :, b] for b in range(B)]).astype(np.int32))
    bp = torch.as_tensor((rng.random((B, n)) < 0.2).astype(np.int32))
    want, (trips, *_) = gf2.gf2_osd0(Ht, resid, bp, n, return_work=True)
    assert trips.tolist() == list(range(1, B + 1))
    assert torch.equal(gf2.gf2_osd0_blocked(Ht, resid, bp, n, panel), want)


@pytest.mark.parametrize("panel", [3, 16, 0])
def test_blocked_refuses_other_panel_widths(panel):
    Ht = torch.zeros((1, 1, 4), dtype=torch.int32)
    s = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="panel"):
        gf2.gf2_eliminate_blocked(Ht, s, 8, panel)
    with pytest.raises(ValueError, match="panel"):
        gf2.gf2_osd0_blocked(Ht, s, torch.zeros((1, 8), dtype=torch.int32), 8, panel)
    with pytest.raises(ValueError, match="panel"):
        cuda_gf2.launch_plan(1, 4, osd0=True, panel=panel)


@pytest.mark.parametrize("panel", [4, 8])
def test_blocked_forms_match_reference_kernels(panel):
    """The reference package's Pallas kernels in interpret mode (the cases of
    its tests/test_pallas.py) against the blocked forms."""
    rng, H = random_system(6 + panel, 3, 60, 80, 0.3)
    B, m, n = H.shape
    Ht = pack(H)
    Ht_ref = jnp.asarray(Ht.numpy().view(np.uint32))
    s = (rng.random((B, m)) < 0.5).astype(np.uint32)
    want = gf2_eliminate_pallas(Ht_ref, jnp.asarray(s), n, interpret=True)
    got = gf2.gf2_eliminate_blocked(Ht, torch.as_tensor(s.astype(np.int32)), n, panel)
    assert np.array_equal(got[0].numpy().view(np.uint32), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy().view(np.uint32), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    bp = (rng.random((B, n)) < 0.2).astype(np.uint32)
    resid = (np.einsum("bmn,bn->bm", H, (rng.random((B, n)) < 0.1)) % 2).astype(np.uint32)
    resid[0] = rng.random(m) < 0.5
    want0 = np.asarray(gf2_osd0_pallas(Ht_ref, jnp.asarray(resid), jnp.asarray(bp), n,
                                       interpret=True))
    got0 = gf2.gf2_osd0_blocked(Ht, torch.as_tensor(resid.astype(np.int32)),
                                torch.as_tensor(bp.astype(np.int32)), n, panel)
    assert np.array_equal(got0.numpy().view(np.uint32), want0)


def old_smem_bytes(W, m, osd0):
    """What the column-by-column kernels took: two pivot slots, the pivot
    map, the syndrome (double-buffered for OSD-0) and the lane."""
    return 4 * (2 + m * (1 + (2 if osd0 else 1)) + W * m)


@pytest.mark.parametrize("osd0", [True, False])
def test_launch_plan_of_the_benchmark_lane(osd0):
    """(1000, 10, 9): panels of 8 columns, the padded stride, one block per SM."""
    plan = cuda_gf2.launch_plan(32, 900, osd0=osd0)
    assert plan.panel == 8 and plan.pad and plan.bp_bits == osd0
    assert cuda_gf2.MAX_SMEM_BYTES // 2 < plan.bytes <= cuda_gf2.MAX_SMEM_BYTES
    assert plan.bytes == cuda_gf2.smem_bytes(32, 900, osd0=osd0)
    assert cuda_gf2.row_stride(900, True) == 900 and cuda_gf2.row_stride(900, False) == 900
    assert [cuda_gf2.row_stride(m, True) for m in (897, 901, 1400, 31)] == [900, 908, 1404, 36]
    narrower = [cuda_gf2.launch_plan(32, 900, osd0=osd0, panel=p) for p in (4, 2, 1)]
    assert [p.panel for p in narrower] == [4, 2, 1]
    assert plan.bytes > narrower[0].bytes > narrower[1].bytes > narrower[2].bytes


@pytest.mark.parametrize("osd0", [True, False])
def test_launch_plan_narrows_the_panel_where_the_table_does_not_fit(osd0):
    """m=1400, n=1120 took 212,808 bytes (OSD-0) of 232,448 column by column:
    a table of 256 rows does not fit beside it, one of 16 rows does."""
    W, m = 35, 1400
    assert old_smem_bytes(W, m, osd0) <= cuda_gf2.MAX_SMEM_BYTES
    plan = cuda_gf2.launch_plan(W, m, osd0=osd0)
    assert plan.panel == 4 and plan.pad and plan.bytes <= cuda_gf2.MAX_SMEM_BYTES
    # the bb144 circuit-level DEM lane (864 x 31,648) fits no block
    dem = cuda_gf2.launch_plan((31648 + 31) // 32, 864, osd0=osd0)
    assert dem.panel == 0 and dem.bytes > cuda_gf2.MAX_SMEM_BYTES


@pytest.mark.parametrize("osd0", [True, False])
def test_launch_plan_refuses_no_lane_that_fitted_before(osd0):
    """Every lane of 8 or more rows that the column-by-column kernels took
    still gets a plan, down to the bare lane with panels of one column."""
    rows = list(range(8, 300)) + list(range(300, 58000, 211))
    for m in rows:
        widest = (cuda_gf2.MAX_SMEM_BYTES // 4 - 2 - m * (3 if osd0 else 2)) // m
        for W in range(max(1, widest - 2), widest + 1):
            if old_smem_bytes(W, m, osd0) > cuda_gf2.MAX_SMEM_BYTES or 32 * W >= 1 << 23:
                continue
            plan = cuda_gf2.launch_plan(W, m, osd0=osd0)
            assert 1 <= plan.panel <= 8 and plan.bytes <= cuda_gf2.MAX_SMEM_BYTES, (W, m)
