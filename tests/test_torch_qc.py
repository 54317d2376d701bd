"""Port parity: quasi-cyclic and bicycle codes, and the whole-decode
group-circulant decoder.

The same seeded numpy inputs go through ``ldpcdecoders_tpu`` (JAX on the
CPU; its fused Pallas kernel in interpret mode with ``batch_tile=8``, as
tests/test_qc.py runs it) and ``ldpcdecoders_tpu_torch`` on the CPU, where
the ``"cuda"`` backend runs the kernel's plain torch version
(``qc_minsum_ref``).  Each interpret-mode reference decoder is built once
per module: its compile is the slow part.

Tolerances, each stated where it is used:

  * the numpy layers (code construction, lifting, adjacency) are bitwise;
  * ``err`` / ``converged`` / ``iters`` are equal on every lane everywhere;
  * min-sum LLRs are bitwise where no inexact product feeds a sum: alpha 1
    or beta 0 (which covers every default), or an alpha whose products are
    exact (a power of two).  With alpha and beta both non-trivial and the
    product inexact, the compiled reference contracts ``alpha * x - beta``
    into a fused multiply-add; the port rounds the product first (as torch
    does, and the CUDA kernel's ``__fmul_rn``).  ``jax.disable_jit()`` does
    not reach inside the interpreted kernel (measured: the same bits with
    and without it), so that case is held two ways: against the compiled
    kernel, flags equal on every lane and LLRs within ``FMA_SPACINGS``
    float32 spacings of the largest LLR after 6 sweeps (measured 160 on one
    value); and, layered, bitwise at full depth against the reference
    package's own op-by-op numpy emulation of the kernel
    (tests/test_qc.py ``_layered_qc_reference``), which rounds the product
    on its own;
  * sum-product LLRs: torch's and XLA's ``tanh`` / ``log1p`` differ by a
    float32 spacing, and near the clamp ``TANH_CLAMP`` = 0.99999 one spacing
    of a tanh product (2**-24) moves a message by ``2 / (1 - TANH_CLAMP**2)``
    = 1e5 times as much, 6e-3.  LLRs agree within ``SP_ATOL`` = 4 such steps
    (measured up to 1.6), with rtol 1e-5; the median difference is under 1e-4
    (measured 1.05e-5 at most).
    With bfloat16 storage a value can also land on the neighbouring
    bfloat16: one ulp, 2**-7 relative.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.codes import bicycle as ref_bicycle
from ldpcdecoders_tpu.codes import qc as ref_qc
from ldpcdecoders_tpu.ops import pallas_qc as ref_pallas_qc
from ldpcdecoders_tpu.utils import metrics as ref_metrics
from ldpcdecoders_tpu_torch.codes import bicycle, qc
from ldpcdecoders_tpu_torch.models.qc_minsum import qc_terms_from_reference
from ldpcdecoders_tpu_torch.ops import cuda_qc
from ldpcdecoders_tpu_torch.ops.clamps import TANH_CLAMP
from ldpcdecoders_tpu_torch.ops.qc_minsum import (
    HELD_EDGES,
    SIGN_BITS,
    SMEM_LIMIT,
    QCTerms,
    qc_flooding_state,
    qc_launch_shape,
    qc_minsum_ref,
    qc_smem_bytes,
    qc_term_adjacency,
)
from ldpcdecoders_tpu_torch.utils.metrics import gf2_kernel_basis
from test_qc import _layered_qc_reference

torch.set_num_threads(1)

SP_ATOL = 4 * 2.0**-24 * 2 / (1 - TANH_CLAMP**2)
FMA_SPACINGS = 512
BF16_ULP = 2.0**-7
JNP_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


# ---- the carried numpy layers ------------------------------------------------


@pytest.mark.parametrize("nb,wr,wc,Z,seed",
                         [(6, 3, 2, 16, 5), (8, 4, 2, 16, 3), (24, 6, 3, 128, 7)])
def test_qc_construction_matches_reference(nb, wr, wc, Z, seed):
    base = qc.random_qc_base_matrix(nb, wr, wc, Z, rng=seed)
    base_ref = ref_qc.random_qc_base_matrix(nb, wr, wc, Z, rng=seed)
    assert base.dtype == base_ref.dtype and np.array_equal(base, base_ref)
    a = qc.random_qc_base_matrix(nb, wr, wc, Z, rng=np.random.default_rng(seed))
    assert np.array_equal(a, base)
    for got, want in zip(qc.qc_lift_edges(base, Z), ref_qc.qc_lift_edges(base, Z)):
        assert np.array_equal(got, want)
    H, H_ref = qc.qc_lift(base, Z), ref_qc.qc_lift(base, Z)
    assert H.dtype == H_ref.dtype and np.array_equal(H, H_ref)


def test_qc_base_matrix_io_and_validation(tmp_path):
    base = qc.random_qc_base_matrix(8, 4, 2, 64, rng=1)
    qc.save_base_matrix(base, 64, tmp_path / "port.txt")
    ref_qc.save_base_matrix(base, 64, tmp_path / "ref.txt")
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "ref.txt").read_text()
    loaded, Z = qc.load_base_matrix(tmp_path / "ref.txt")
    assert Z == 64 and np.array_equal(loaded, base)
    with pytest.raises(ValueError, match="shifts in"):
        qc.qc_lift([[5]], 4)
    with pytest.raises(ValueError, match="2-D"):
        qc.qc_lift([1, 2], 4)


def test_qc_group_lift_matches_reference():
    rng = np.random.default_rng(4)
    terms = sorted({(int(rng.integers(3)), int(rng.integers(5)), int(rng.integers(4)),
                     int(rng.integers(6))) for _ in range(20)})
    for got, want in zip(qc.qc_group_lift_edges(terms, 3, 5, 4, 6),
                         ref_qc.qc_group_lift_edges(terms, 3, 5, 4, 6)):
        assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="duplicate term"):
        qc.qc_group_lift_edges([(0, 0, 1, 1), (0, 0, 1, 1)], 1, 1, 2, 2)
    with pytest.raises(ValueError, match="outside"):
        qc.qc_group_lift_edges([(0, 1, 0, 0)], 1, 1, 2, 2)


@pytest.mark.parametrize("name", sorted(bicycle.BICYCLE_CODES))
def test_bicycle_codes_match_reference(name):
    assert bicycle.BICYCLE_CODES[name] == ref_bicycle.BICYCLE_CODES[name]
    Hx, Hz, info = bicycle.named_bicycle_code(name)
    Hx_ref, Hz_ref, info_ref = ref_bicycle.named_bicycle_code(name)
    assert info == info_ref
    assert Hx.dtype == Hx_ref.dtype and np.array_equal(Hx, Hx_ref) and np.array_equal(Hz, Hz_ref)
    assert not ((Hx.astype(np.int64) @ Hz.T) % 2).any()  # CSS condition
    if info["n"] <= 108:  # the rank is a dense elimination: the smaller codes
        assert bicycle.css_code_k(Hx, Hz) == info["k"] == ref_bicycle.css_code_k(Hx, Hz)
    with pytest.raises(ValueError, match="unknown BB code"):
        bicycle.named_bicycle_code("bb9000")


def test_bb_poly_matrix_and_kernel_basis_match_reference():
    terms = [(3, 0), (0, 1), (0, 2), (3, 0), (1, 1)]  # a repeated term cancels
    assert np.array_equal(bicycle.bb_poly_matrix(6, 4, terms),
                          ref_bicycle.bb_poly_matrix(6, 4, terms))
    rng = np.random.default_rng(8)
    H = (rng.random((20, 45)) < 0.15).astype(np.uint8)
    H[7] = H[3] ^ H[5]  # a dependent row
    basis = gf2_kernel_basis(H)
    assert np.array_equal(basis, ref_metrics.gf2_kernel_basis(H))
    assert not ((H.astype(np.int64) @ basis.T) % 2).any()


def test_term_adjacency_and_table_match_reference():
    _, _, info = bicycle.named_bicycle_code("bb72")
    terms = [(1, 0, a, b) for a, b in info["a_terms"]] + [(0, 1, a, b) for a, b in
                                                          info["b_terms"]] + [(0, 0, 0, 0)]
    got = qc_term_adjacency(terms, 2, 2)
    want = ref_pallas_qc.qc_term_adjacency(terms, 2, 2)
    assert got == want
    t = QCTerms.build(terms, 2, 2, (6, 6))
    assert (t.Z, t.Eb, t.max_row_weight) == (36, 7, 4)
    edges, row_edges, col_edges = got
    tab = t.table()
    assert tab.dtype == np.int32 and tab.shape == (4 * 7 + 2 + 2 + 2,)
    assert tab[:7].tolist() == [e[1] for e in edges]
    assert tab[7:14].tolist() == [e[2] for e in edges]
    assert tab[14:21].tolist() == [e[3] for e in edges]
    row_ptr, col_ptr, col_idx = tab[21:24], tab[24:27], tab[27:]
    for i, r in enumerate(row_edges):  # a row's edges are one contiguous range
        assert list(range(row_ptr[i], row_ptr[i + 1])) == r
    for j, c in enumerate(col_edges):
        assert col_idx[col_ptr[j]:col_ptr[j + 1]].tolist() == c
    with pytest.raises(ValueError, match="duplicate edge terms"):
        qc_term_adjacency([(0, 0, 1, 0), (0, 0, 1, 0)], 1, 1)
    with pytest.raises(ValueError, match="base column 1 has no edges"):
        qc_term_adjacency([(0, 0, 1, 0)], 1, 2)
    with pytest.raises(ValueError, match="outside"):
        QCTerms.build([(0, 0, 6, 0)], 1, 1, (6, 6))


def _terms_of(base, Z):
    base = np.asarray(base)
    bi, bj = np.nonzero(base >= 0)
    return QCTerms.build([(int(i), int(j), int(base[i, j]), 0) for i, j in zip(bi, bj)],
                         *base.shape, (Z, 1))


def test_shared_memory_estimate_and_refusal():
    """The sizes the kernel's design rests on, and the refusal past a block's
    232,448 B (the card is not needed to compute them)."""
    bench = _terms_of(qc.random_qc_base_matrix(24, 6, 3, 128, rng=7), 128)
    assert (bench.mb, bench.nb, bench.Eb, bench.max_row_weight) == (12, 24, 72, 6)
    # layered: messages + totals 49,152 B and the table in the kernel's form
    # (1,648 B: four words an edge, the pointers, the column edge list, a
    # flag a row, two sweep flags) and the syndromes.  Flooding: two tables
    # of four words an edge and the pointers (2,456 B), the float32 totals
    # (12,288 B), the two-min states (two float32 magnitudes and a word a
    # check position, 18,432 B; bfloat16 magnitudes 12,288 B) or, for
    # sum-product, every edge's message (36,864 B), the syndromes (1,536 B);
    # a prior on chip adds 12,288 B.  Every row has distinct block columns:
    # no row buffer, and rows of weight 6 <= HELD_EDGES need no sum-product
    # slots
    assert not any(bench.two_phase_rows) and bench.buffered_row_weight == 0
    assert qc_smem_bytes(bench, 128, 4, True, False) == 49_152 + 1_648 + 1_536
    assert qc_smem_bytes(bench, 128, 4, False, False) == 2_456 + 12_288 + 18_432 + 1_536
    assert qc_smem_bytes(bench, 128, 2, False, False) == 2_456 + 12_288 + 12_288 + 1_536
    assert qc_smem_bytes(bench, 128, 4, False, True) == 2_456 + 12_288 + 36_864 + 1_536
    assert qc_smem_bytes(bench, 128, 4, False, False, prior=True) == 34_712 + 12_288
    assert qc_flooding_state(bench, False) == "two_min"
    assert qc_flooding_state(bench, True) == "messages"
    assert qc_smem_bytes(bench, 128, 2, True, False) == 24_576 + 1_648 + 1_536
    assert qc_smem_bytes(bench, 128, 4, True, True) == qc_smem_bytes(bench, 128, 4, True, False)
    assert qc_launch_shape(bench, 4, True, False) == (128, 52_336)
    # bb72: one row of weight 6 with three terms in each block column: a row
    # buffer of 6 x 36 float32 beside messages + totals, table and syndromes
    _, _, info = bicycle.named_bicycle_code("bb72")
    bb = QCTerms.build([(0, 0, a, b) for a, b in info["a_terms"]]
                       + [(0, 1, a, b) for a, b in info["b_terms"]], 1, 2, (6, 6))
    assert bb.two_phase_rows == (True,) and bb.buffered_row_weight == 6
    assert qc_smem_bytes(bb, 36, 4, True, False) == (6 + 2) * 36 * 4 + 152 + 6 * 36 * 4 + 36
    # a row of weight 11 keeps 3 suffix products a thread in sum-product
    heavy = QCTerms.build([(0, j, 0, 0) for j in range(11)], 1, 11, (5, 1))
    assert qc_smem_bytes(heavy, 5, 4, True, True) - qc_smem_bytes(
        heavy, 5, 4, True, False) == (11 - HELD_EDGES) * 5 * 4
    # one lane per block, a thread per position of the lift, however small;
    # flooding takes a group of Z threads per base row or column, up to 512
    # threads (here 6 block columns: 6 groups), layered one group
    small = _terms_of(qc.random_qc_base_matrix(6, 3, 2, 16, rng=5), 16)
    assert (small.mb, small.nb) == (4, 6)
    assert qc_launch_shape(small, 4, False, False)[0] == 6 * 16
    assert qc_launch_shape(small, 4, True, False)[0] == 16
    assert qc_launch_shape(bench, 4, False, False) == (4 * 128, 34_712)
    assert qc_launch_shape(bench, 4, False, False, prior=True) == (4 * 128, 34_712 + 12_288)
    # a row of 80 keeps 72 sum-product slots a thread: four groups would
    # need 233,072 B, so the launch takes three
    slots = QCTerms.build([(0, j, 0, 0) for j in range(80)] + [(1, 0, 1, 0)], 2, 80, (128, 1))
    assert qc_smem_bytes(slots, 4 * 128, 4, False, True) == 233_072
    assert qc_launch_shape(slots, 4, False, True) == (3 * 128, 196_208)
    assert qc_launch_shape(slots, 4, False, False)[0] == 4 * 128
    # Z above 1024: positions strided over 1024 threads
    assert qc_launch_shape(_terms_of([[0, 5]], 1100), 4, True, False)[0] == 1024
    # the same base graph at Z=512: layered float32 fits alone, and so does
    # flooding float32 with its two-min states (131,480 B); at Z=1024
    # flooding float32 does not (260,504 B), flooding bfloat16 does, and a
    # prior that does not fit beside the lane stays in device memory
    big = _terms_of(qc.random_qc_base_matrix(24, 6, 3, 512, rng=7), 512)
    assert 196_608 < qc_launch_shape(big, 4, True, False)[1] <= SMEM_LIMIT
    assert qc_launch_shape(big, 4, False, False) == (512, 131_480)
    assert qc_launch_shape(big, 4, False, False, prior=True) == (512, 131_480 + 49_152)
    huge = _terms_of(qc.random_qc_base_matrix(24, 6, 3, 1024, rng=7), 1024)
    with pytest.raises(ValueError, match="shared memory.*bfloat16.*backend='lifted'"):
        qc_launch_shape(huge, 4, False, False)
    assert qc_launch_shape(huge, 2, False, False) == (1024, 211_352)
    assert qc_launch_shape(huge, 2, False, False, prior=True) == (1024, 211_352)
    # a CPU decoder runs the plain version, which has no such limit
    pt.QCMinSumDecoder(qc.random_qc_base_matrix(24, 6, 3, 1024, rng=7), 1024, 0.04, 2,
                       device="cpu")



def _two_phase_cases():
    """(QCTerms, the lifted matrix the repo builds for it) of the repo's QC
    codes: the reference benchmark's QC extra, both blocks of bb72 and bb144,
    and space-time lifts."""
    base = qc.random_qc_base_matrix(24, 6, 3, 128, rng=7)
    yield "qc_bench", _terms_of(base, 128), qc.qc_lift(base, 128)
    for code in ("bb72", "bb144"):
        Hx, Hz, _ = bicycle.named_bicycle_code(code)
        for block, H in (("x", Hx), ("z", Hz)):
            dec = pt.QCMinSumDecoder.for_bicycle(code, block, 0.01, 4, device="cpu")
            yield f"{code}_{block}", dec.qc_terms, H
    for code, rounds, perfect in (("bb72", 3, True), ("bb144", 6, True), ("bb72", 2, False)):
        st = pt.SpaceTimeDecoder.for_bicycle(code, "x", rounds, 0.01, 4, perfect_last=perfect,
                                             device="cpu")
        yield f"{code}_R{rounds}", st.inner.qc_terms, st.A.toarray()


@pytest.mark.parametrize("case", range(8))
def test_two_phase_rows_match_a_numpy_recount(case):
    """The rows the kernel's layered sweep updates in two phases (some block
    column holds two of the row's terms) and the row buffer's size, against
    the weights of each row block of the lifted matrix (distinct shifts
    never meet, so a block's row weight is its number of terms)."""
    name, terms, H = list(_two_phase_cases())[case]
    Z, nb = terms.Z, terms.nb
    assert H.shape == (terms.mb * Z, nb * Z), name
    weights = [np.asarray(H[i * Z]).reshape(nb, Z).sum(axis=1) for i in range(terms.mb)]
    assert [int(w.sum()) for w in weights] == [len(r) for r in terms.row_edges], name
    assert terms.two_phase_rows == tuple(bool(w.max() >= 2) for w in weights), name
    assert terms.buffered_row_weight == max(
        (int(w.sum()) for w in weights if w.max() >= 2), default=0), name
    want_two = {"qc_bench": 0}.get(name, terms.mb)  # every bicycle row repeats a column
    assert sum(terms.two_phase_rows) == want_two, name

# ---- the decoder against the reference's fused kernel ------------------------


@pytest.mark.parametrize("case", range(8))
def test_flooding_bytes_match_a_numpy_recount(case):
    """The flooding sweep's shared memory against counts of the lifted
    matrix: its nonzeros (``Eb * Z`` edges), rows, columns and heaviest row
    (which decides between two-min states and messages, and the
    sum-product slots past :data:`HELD_EDGES`), on ``Z`` threads."""
    name, terms, H = list(_two_phase_cases())[case]
    H = np.asarray(H)
    Z, (checks, bits), edges = terms.Z, H.shape, int(H.sum())
    rw = int(H.sum(axis=1).max())
    assert edges % Z == 0 and checks % Z == 0 and bits % Z == 0, name
    tables = 4 * (8 * edges // Z + checks // Z + bits // Z + 2)
    for size in (4, 2):
        for sumprod in (False, True):
            two_min = not sumprod and rw <= SIGN_BITS
            state = (2 * size + 4) * checks if two_min else size * edges
            slots = 4 * max(rw - HELD_EDGES, 0) * Z if sumprod else 0
            want = tables + 4 * bits + state + checks + slots
            assert qc_smem_bytes(terms, Z, size, False, sumprod) == want, (name, size, sumprod)
            assert qc_smem_bytes(terms, Z, size, False, sumprod, prior=True) == want + 4 * bits
            assert qc_flooding_state(terms, sumprod) == ("two_min" if two_min else "messages")


@pytest.fixture(scope="module")
def small_qc():
    base = qc.random_qc_base_matrix(6, 3, 2, 16, rng=5)  # mb=4, Eb=12
    return base, 16, qc.qc_lift(base, 16)


@functools.lru_cache(maxsize=None)
def ref_decoder(schedule, algorithm, dtype, per=0.05, max_iters=12, alpha=None, beta=0.0):
    """The reference decoder on the small code: fused kernel, interpret mode."""
    base = qc.random_qc_base_matrix(6, 3, 2, 16, rng=5)
    return lt.QCMinSumDecoder(base, 16, per, max_iters, backend="pallas", interpret=True,
                              batch_tile=8, schedule=schedule, algorithm=algorithm,
                              dtype=JNP_DTYPE[dtype], alpha=alpha, beta=beta)


def port_of(ref, **kw):
    """The port's decoder from the reference decoder's description."""
    return pt.QCMinSumDecoder.from_group_terms(**qc_terms_from_reference(ref), device="cpu", **kw)


def syndromes_of(H, per, B, seed):
    rng = np.random.default_rng(seed)
    errs = rng.random((B, H.shape[1])) < per
    return ((errs @ H.T) % 2).astype(np.int8)


def assert_flags_equal(got, want):
    for g, w in zip(got[:3], want[:3]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def assert_llrs(got, want, algorithm, dtype):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.float32
    if algorithm == "minsum":
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(got, want, rtol=rtol, atol=SP_ATOL)
        assert np.median(np.abs(got - want)) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("algorithm", ["minsum", "sumproduct"])
@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_decoder_matches_reference_kernel(small_qc, schedule, algorithm, dtype):
    base, Z, H = small_qc
    ref = ref_decoder(schedule, algorithm, dtype)
    dec = port_of(ref)
    assert dec.alpha == ref.alpha == (0.8 if (schedule, algorithm) == ("layered", "minsum")
                                      else 1.0)
    assert np.array_equal(dec.graph.H, np.asarray(ref.graph.H)) and dec.backend == "cuda"
    # 13 lanes (no multiple of the reference's tile of 8): nine at a noise
    # where lanes stop at different sweeps, four where most never do
    syn = np.concatenate([syndromes_of(H, 0.05, 9, seed=2), syndromes_of(H, 0.2, 4, seed=3)])
    want = ref.batch_decode_detailed(syn)
    got = dec.batch_decode_detailed(syn)
    assert len(set(want[2].tolist())) >= 3 and not want[1].all()
    assert_flags_equal(got, want)
    assert_llrs(got[3]["llrs"], want[3]["llrs"], algorithm, dtype)
    assert dataclasses.asdict(got[4]) == dataclasses.asdict(want[4])  # DecodeStats
    # the plain version called directly, and a decoder built from the base matrix
    kw = dict(alpha=dec.alpha, beta=dec.beta, schedule=schedule, algorithm=algorithm,
              dtype=dtype)
    direct = qc_minsum_ref(torch.as_tensor(syn), dec.qc_terms, dec.L0, dec.max_iters, **kw)
    twin = pt.QCMinSumDecoder(base, Z, 0.05, 12, device="cpu", schedule=schedule,
                              algorithm=algorithm, dtype=dtype).batch_decode_detailed(syn)
    for out in (direct, twin):
        for g, w in zip(out[:3], got[:3]):
            assert np.array_equal(np.asarray(g), w)
    assert torch.equal(direct[3], torch.as_tensor(got[3]["llrs"]))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_per_override_matches_reference_kernel(small_qc, schedule):
    """Scalar, per-bit and per-lane priors (erased bits at 0.5) go through
    the reference's lazily built prior-input kernel and the port's priors
    argument; the baked path is intact afterwards."""
    base, Z, H = small_qc
    ref = ref_decoder(schedule, "minsum", torch.float32)
    dec = port_of(ref)
    rng = np.random.default_rng(2)
    B, n, per = 6, dec.n, 0.05
    eps = rng.random((B, n)) < 0.08
    e = np.where(eps, rng.random((B, n)) < 0.5, rng.random((B, n)) < per)
    syn = ((e @ H.T) % 2).astype(np.int8)
    for p in (np.where(eps, 0.5, per), 0.03, np.full(n, 0.02), None):
        want = ref.batch_decode_detailed(syn, per=p)
        got = dec.batch_decode_detailed(syn, per=p)
        assert_flags_equal(got, want)
        assert_llrs(got[3]["llrs"], want[3]["llrs"], "minsum", torch.float32)
    with pytest.raises(ValueError, match="per must be"):
        dec.batch_decode(np.zeros((4, dec.m), np.int8), per=np.full(n + 1, 0.1))
    with pytest.raises(ValueError, match="per-lane prior batch"):
        dec.batch_decode(syn, per=np.full((B + 1, n), 0.1))


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
@pytest.mark.parametrize("alpha", [0.5, 0.8])
def test_alpha_and_beta_match_reference_kernel(small_qc, schedule, alpha):
    """alpha and beta both non-trivial.  alpha 0.5: every product is exact,
    so a fused multiply-add changes nothing: bitwise.  alpha 0.8: the
    compiled reference contracts ``alpha * x - beta``; flags equal on every
    lane, LLRs within FMA_SPACINGS float32 spacings of the largest LLR."""
    base, Z, H = small_qc
    ref = lt.QCMinSumDecoder(base, Z, 0.05, 6, backend="pallas", interpret=True, batch_tile=8,
                             schedule=schedule, alpha=alpha, beta=0.15)
    dec = port_of(ref)
    syn = syndromes_of(H, 0.05, 8, seed=2)
    want = ref.batch_decode_detailed(syn)
    got = dec.batch_decode_detailed(syn)
    assert_flags_equal(got, want)
    if alpha == 0.5:
        assert_llrs(got[3]["llrs"], want[3]["llrs"], "minsum", torch.float32)
    else:
        want_llrs = np.asarray(want[3]["llrs"])
        atol = FMA_SPACINGS * np.spacing(np.abs(want_llrs).max())
        np.testing.assert_allclose(got[3]["llrs"], want_llrs, rtol=0, atol=atol)


def test_inexact_alpha_and_beta_match_reference_emulation_bitwise(small_qc):
    """The witness that the fused multiply-add is the only difference: the
    reference package's op-by-op numpy emulation of the layered kernel
    rounds ``alpha * x`` before it subtracts beta, and the port equals it on
    every bit at full depth."""
    base, Z, H = small_qc
    dec = pt.QCMinSumDecoder(base, Z, 0.04, 12, schedule="layered", alpha=0.8, beta=0.15,
                             device="cpu")
    syn = np.concatenate([syndromes_of(H, 0.05, 12, seed=6), syndromes_of(H, 0.2, 4, seed=7)])
    err, conv, iters, llrs = _layered_qc_reference(base, Z, 0.04, 12, 0.8, 0.15, syn)
    got = dec.batch_decode_detailed(syn)
    assert not conv.all() and len(set(iters.tolist())) >= 3
    assert_flags_equal(got, (err, conv, iters))
    assert_llrs(got[3]["llrs"], llrs, "minsum", torch.float32)


@functools.lru_cache(maxsize=None)
def ref_bicycle_decoder(block, schedule):
    return lt.QCMinSumDecoder.for_bicycle("bb72", block, 0.01, 20, backend="pallas",
                                          interpret=True, batch_tile=8, schedule=schedule)


@pytest.mark.parametrize("block,schedule", [("x", "flooding"), ("z", "layered"),
                                            ("x", "layered")])
def test_for_bicycle_matches_reference_kernel(block, schedule):
    """Several terms per block: the layered update applies a row's edges into
    one block column in edge order, the flooding sum runs in sorted-term
    order, as the reference does: bitwise, LLRs included."""
    Hx, Hz, _ = bicycle.named_bicycle_code("bb72")
    H = Hx if block == "x" else Hz
    ref = ref_bicycle_decoder(block, schedule)
    dec = pt.QCMinSumDecoder.for_bicycle("bb72", block, 0.01, 20, schedule=schedule,
                                         device="cpu")
    assert np.array_equal(dec.graph.H, H) and (dec.m, dec.n) == (36, 72)
    assert [tuple(t) for t in dec.terms] == [tuple(t) for t in ref.terms]
    assert dec.group == ref.group == (6, 6)
    syn = syndromes_of(H, 0.03, 16, seed=7)
    want = ref.batch_decode_detailed(syn)
    got = dec.batch_decode_detailed(syn)
    assert want[1].any() and len(set(want[2].tolist())) >= 3
    assert_flags_equal(got, want)
    assert_llrs(got[3]["llrs"], want[3]["llrs"], "minsum", torch.float32)
    conv = got[1]
    assert (((got[0].astype(np.int64) @ H.T) % 2)[conv] == syn[conv]).all()


def test_for_bicycle_validation_and_tuple_code():
    with pytest.raises(ValueError, match="block must be"):
        pt.QCMinSumDecoder.for_bicycle("bb72", "y", 0.01, 10, device="cpu")
    with pytest.raises(ValueError, match="unknown BB code"):
        pt.QCMinSumDecoder.for_bicycle("bb9000", "x", 0.01, 10, device="cpu")
    info = bicycle.BICYCLE_CODES["bb90"]
    code = (info["l"], info["m"], info["a_terms"], info["b_terms"])
    a = pt.QCMinSumDecoder.for_bicycle(code, "z", 0.01, 10, device="cpu")
    b = pt.QCMinSumDecoder.for_bicycle("bb90", "z", 0.01, 10, device="cpu")
    assert a.terms == b.terms and np.array_equal(a.graph.H, bicycle.named_bicycle_code("bb90")[1])


def test_weight_one_row_finite_llrs():
    """A weight-1 base row sends the finite 1e30 sentinel, clamped by nothing:
    the LLRs stay finite and equal the reference's."""
    base = np.array([[0], [1]])
    ref = lt.QCMinSumDecoder(base, 4, 0.05, 5, backend="pallas", interpret=True, batch_tile=4)
    dec = port_of(ref)
    syn = np.zeros((4, dec.m), np.int8)
    syn[0, 0] = 1
    want = ref.batch_decode_detailed(syn)
    got = dec.batch_decode_detailed(syn)
    assert np.isfinite(got[3]["llrs"]).all()
    assert_flags_equal(got, want)
    assert_llrs(got[3]["llrs"], want[3]["llrs"], "minsum", torch.float32)


def test_cuda_backend_on_cpu_matches_lifted_backend(small_qc):
    """Single-term 1-D code, flooding: the whole-decode path and the generic
    min-sum decoder on the lifted graph order every check's neighbours alike,
    so err / converged / iters are equal on every lane.  The two variable
    updates associate their float32 sum differently (prior first against
    prior last), so LLRs agree within rtol 1e-5, atol 1e-5."""
    base, Z, H = small_qc
    fused = pt.QCMinSumDecoder(base, Z, 0.05, 10, device="cpu")
    lifted = pt.QCMinSumDecoder(base, Z, 0.05, 10, backend="lifted", device="cpu")
    assert pt.QCMinSumDecoder(base, Z, 0.05, 10, backend="auto", device="cpu").backend == "cuda"
    syn = syndromes_of(H, 0.03, 16, seed=2)
    want = lifted.batch_decode_detailed(syn)
    got = fused.batch_decode_detailed(syn)
    assert_flags_equal(got, want)
    np.testing.assert_allclose(got[3]["llrs"], want[3]["llrs"], rtol=1e-5, atol=1e-5)
    for p in (0.03, np.full(fused.n, 0.02)):
        assert_flags_equal(fused.batch_decode_detailed(syn, per=p),
                           lifted.batch_decode_detailed(syn, per=p))
    # single decode equals lane 0 of the batch
    e0, c0 = fused.decode(syn[0])
    assert np.array_equal(e0, got[0][0]) and c0 == bool(got[1][0])


def test_fused_and_lifted_flooding_part_only_at_a_rounding_residue():
    """At per 0.04 some lanes of the two flooding backends do part.  Sweep by
    sweep (``max_iters`` 1, 2, ...): until a lane's decisions first differ its
    LLRs agree within rtol 1e-5, atol 1e-5, and where they first differ both
    totals are a rounding residue of the float32 sum (at most 1e-5 against
    messages of magnitude 3 and more: prior first gives 0.0, prior last
    -1.9e-6).  After 20 sweeps the same lanes have converged, to the same
    corrections (a lane that parted may need a sweep more or less); only
    lanes that never converge end apart."""
    base = qc.random_qc_base_matrix(12, 6, 3, 64, rng=3)
    H = qc.qc_lift(base, 64)
    rng = np.random.default_rng(4)
    syn = (((rng.random((48, H.shape[1])) < 0.04) @ H.T) % 2).astype(np.uint8)

    def both(iters):
        return [pt.QCMinSumDecoder(base, 64, 0.04, iters, backend=b, device="cpu")
                .batch_decode_detailed(syn) for b in ("cuda", "lifted")]

    parted = np.zeros(48, bool)
    for iters in range(1, 11):
        got, want = both(iters)
        la, lb = got[3]["llrs"], want[3]["llrs"]
        differ = got[0] != want[0]
        new = differ.any(axis=1) & ~parted
        assert np.maximum(np.abs(la), np.abs(lb))[differ & new[:, None]].max(initial=0) <= 1e-5
        together = ~parted & ~new
        np.testing.assert_allclose(la[together], lb[together], rtol=1e-5, atol=1e-5)
        parted |= new
    assert parted.sum() >= 3  # the batch does show the effect
    got, want = both(20)
    conv = got[1]
    assert conv.sum() >= 20 and np.array_equal(conv, want[1])
    assert np.array_equal(got[2][conv & ~parted], want[2][conv & ~parted])
    assert np.array_equal(got[0][conv], want[0][conv])


def test_lifted_sumproduct_backend_recovers_like_the_kernel_path(small_qc):
    base, Z, H = small_qc
    kw = dict(algorithm="sumproduct", device="cpu")
    fused = pt.QCMinSumDecoder(base, Z, 0.02, 25, **kw)
    lifted = pt.QCMinSumDecoder(base, Z, 0.02, 25, backend="lifted", **kw)
    rng = np.random.default_rng(12)
    errs = (rng.random((16, fused.n)) < 0.015).astype(np.int8)
    syn = (errs @ H.T) % 2
    ep, cp, _, aux_p, _ = fused.batch_decode_detailed(syn)
    ex, cx, _, aux_x, _ = lifted.batch_decode_detailed(syn, per=0.02)
    # tanh-rule against probability-ratio numerics: parity is behavioural
    assert cp.mean() > 0.9 and cx.mean() > 0.9
    assert np.array_equal(ep[cp & cx], ex[cp & cx]) and np.array_equal(ep[cp], errs[cp])
    assert set(aux_p) == {"llrs"} and set(aux_x) == {"log_probabs"}


def test_decoder_validation(small_qc):
    base, Z, _ = small_qc
    with pytest.raises(ValueError, match="unknown backend 'bogus'"):
        pt.QCMinSumDecoder(base, Z, 0.05, 5, backend="bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown schedule"):
        pt.QCMinSumDecoder(base, Z, 0.05, 5, schedule="bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown algorithm"):
        pt.QCMinSumDecoder(base, Z, 0.05, 5, algorithm="bogus", device="cpu")
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pt.QCMinSumDecoder(base, Z, 0.05, 5, dtype=torch.int8, device="cpu")
    # the lifted layered route is the layered min-sum decoder on the lifted graph
    lay = pt.QCMinSumDecoder(base, Z, 0.05, 5, backend="lifted", schedule="layered",
                             device="cpu")
    assert type(lay.lifted).__name__ == "LayeredMinSumDecode" and lay.alpha == 0.8
    assert lay.batch_decode(np.zeros((2, lay.m), np.uint8))[1].all()
    with pytest.raises(ValueError, match="only available on the cuda backend"):
        pt.QCMinSumDecoder(base, Z, 0.05, 5, backend="lifted", schedule="layered",
                           algorithm="sumproduct", device="cpu")
    dec = pt.QCMinSumDecoder(base, Z, 0.05, 5, device="cpu")
    with pytest.raises(ValueError, match=r"expected syndromes of shape \[B, 64\]"):
        dec.batch_decode(np.zeros((2, 63), np.int8))
    with pytest.raises(ValueError, match=r"priors must be \[96\] or \[2, 96\]"):
        cuda_qc.qc_minsum_cuda(torch.zeros((2, 64), dtype=torch.int8), dec.qc_terms, None,
                               3.0, 5, priors=torch.zeros(95))
    # the dense matrix is attached only up to 4M entries
    assert dec.graph.H is not None
    bench = pt.QCMinSumDecoder(qc.random_qc_base_matrix(24, 6, 3, 128, rng=7), 128, 0.04, 32,
                               schedule="layered", device="cpu")
    assert bench.graph.H is None and (bench.m, bench.n, bench.graph.n_edges) == (1536, 3072, 9216)
    e, c = bench.batch_decode(np.zeros((2, 1536), np.int8))
    assert c.all() and not e.any()


def test_no_sweep_and_empty_batch(small_qc):
    base, Z, H = small_qc
    dec = pt.QCMinSumDecoder(base, Z, 0.05, 0, schedule="layered", device="cpu")
    e, c, it, aux, _ = dec.batch_decode_detailed(syndromes_of(H, 0.05, 3, seed=1))
    assert not e.any() and not c.any() and not it.any()
    assert np.array_equal(aux["llrs"], np.full((3, dec.n), np.float32(dec.L0)))
    dec = pt.QCMinSumDecoder(base, Z, 0.05, 5, device="cpu")
    e, c = dec.batch_decode(np.zeros((0, dec.m), np.int8))
    assert e.shape == (0, dec.n) and c.shape == (0,)


def test_decode_soft_punctured_matches_reference(small_qc):
    """decode_soft through per-lane priors: punctured bits (LLR 0) recover
    from parity structure alone, with the reference's codewords."""
    base, Z, H = small_qc
    ref = lt.QCMinSumDecoder(base, Z, 0.02, 40, backend="pallas", interpret=True, batch_tile=4)
    dec = port_of(ref)
    rng = np.random.default_rng(3)
    sigma = 10 ** (-4.0 / 20)
    llr = 2.0 * (1.0 + sigma * rng.standard_normal((8, dec.n))) / sigma**2
    llr[:, :Z] = 0.0  # puncture one block column
    cw_ref, ok_ref = lt.decode_soft(ref, llr)
    cw, ok = pt.decode_soft(dec, llr)
    assert ok.all() and cw.sum() == 0
    assert np.array_equal(cw, np.asarray(cw_ref)) and np.array_equal(ok, np.asarray(ok_ref))
