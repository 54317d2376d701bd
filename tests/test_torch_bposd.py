"""Port parity: bit-packed GF(2) elimination, OSD and the BP+OSD decoder.

The OSD kernels' plain torch versions (``gf2_osd0_ref``,
``gf2_eliminate_ref``) are held bitwise against the reference package's XLA
functions and its Pallas kernels run in interpret mode, as
tests/test_pallas.py runs them.  The OSD stage and the whole decoder are
held bitwise against ``ldpcdecoders_tpu`` and the numpy golden OSD.

One allowance, stated where it is used: OSD ranks columns by
``exp(logp)``, and torch's float32 ``exp`` can differ from XLA's by an
ulp.  A lane may then order two columns whose reliabilities tie to within
a few ulps differently and pick another (still syndrome-consistent)
solution.  Such a lane is shown to be a tie; every other lane must agree
bit for bit.
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.golden import osd_postprocess as golden_osd
from ldpcdecoders_tpu.models.bposd import make_osd_fns as ref_make_osd_fns
from ldpcdecoders_tpu.ops import gf2 as ref_gf2
from ldpcdecoders_tpu.ops.pallas_gf2 import gf2_eliminate_pallas, gf2_osd0_pallas
from ldpcdecoders_tpu_torch.models.bposd import make_osd_fns
from ldpcdecoders_tpu_torch.ops import cuda_gf2
from ldpcdecoders_tpu_torch.ops import gf2 as port_gf2

torch.set_num_threads(1)


def u32(t):
    """int32 tensor -> the uint32 words it carries."""
    return t.numpy().view(np.uint32)


def i32(a):
    """uint32 (or 0/1) array -> int32 tensor with the same bits."""
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a).astype(np.uint32).view(np.int32)))


def packed_systems(rng, B, m, n, dens):
    H = (rng.random((B, m, n)) < dens).astype(np.uint32)
    Hp = jax.vmap(ref_gf2.pack_bits)(jnp.asarray(H))  # [B, m, W]
    return H, Hp, jnp.transpose(Hp, (0, 2, 1))  # Ht [B, W, m]


def test_pack_bits_matches_reference():
    rng = np.random.default_rng(0)
    for shape in ((3, 70), (2, 4, 32), (5, 1), (2, 64)):
        bits = (rng.random(shape) < 0.5).astype(np.uint8)
        bits[..., -1] = 1  # the top bit of a full word sets bit 31
        want = np.asarray(ref_gf2.pack_bits(jnp.asarray(bits)))
        got = port_gf2.pack_bits(torch.as_tensor(bits))
        assert got.dtype == torch.int32
        assert np.array_equal(u32(got), want)


def test_parity32_matches_popcount():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, size=500, dtype=np.uint64).astype(np.uint32)
    want = np.array([bin(int(w)).count("1") & 1 for w in words])
    assert np.array_equal(port_gf2.parity32(i32(words)).numpy(), want)


# the cases of tests/test_pallas.py:79, plus a wider one
@pytest.mark.parametrize("B,m,n,dens", [(4, 60, 80, 0.3), (2, 31, 33, 0.5), (3, 90, 130, 0.08)])
def test_gf2_osd0_ref_matches_reference(B, m, n, dens):
    rng = np.random.default_rng(6 + m)
    H, Hp, Ht = packed_systems(rng, B, m, n, dens)
    bp = (rng.random((B, n)) < 0.2).astype(np.uint32)
    extra = (rng.random((B, n)) < 0.1).astype(np.uint32)
    resid = (np.einsum("bmn,bn->bm", H, extra) % 2).astype(np.uint32)
    resid[0] = rng.random(m) < 0.5  # possibly outside the row space
    want = np.asarray(jax.vmap(lambda hp, b, r: ref_gf2.gf2_osd0(hp, b, r, n))(
        Hp, jnp.asarray(bp), jnp.asarray(resid)))
    want_pallas = np.asarray(gf2_osd0_pallas(Ht, jnp.asarray(resid), jnp.asarray(bp), n,
                                             interpret=True))
    assert np.array_equal(want, want_pallas)
    args = (i32(Ht), i32(resid), i32(bp), n)
    got = cuda_gf2.gf2_osd0_ref(*args)
    assert got.shape == (B, n) and got.dtype == torch.int32
    assert np.array_equal(u32(got), want)
    # on CPU tensors the wrapper runs the plain version and launches nothing
    launches = cuda_gf2.gf2_osd0_cuda.launches
    assert np.array_equal(u32(cuda_gf2.gf2_osd0_cuda(*args)), want)
    assert cuda_gf2.gf2_osd0_cuda.launches == launches


# the cases of tests/test_pallas.py:62
@pytest.mark.parametrize("B,m,n,dens", [(4, 60, 80, 0.3), (2, 96, 240, 0.05), (3, 31, 33, 0.5)])
def test_gf2_eliminate_ref_matches_reference(B, m, n, dens):
    rng = np.random.default_rng(4 + n)
    _, _, Ht = packed_systems(rng, B, m, n, dens)
    s = (rng.random((B, m)) < 0.5).astype(np.uint32)
    want = jax.vmap(lambda ht, sv: ref_gf2.gf2_eliminate(ht, sv, n))(Ht, jnp.asarray(s))
    want_pallas = gf2_eliminate_pallas(Ht, jnp.asarray(s), n, interpret=True)
    for a, b in zip(want[:3], want_pallas):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    got = cuda_gf2.gf2_eliminate_ref(i32(Ht), i32(s), n)
    assert np.array_equal(u32(got[0]), np.asarray(want[0]))
    assert np.array_equal(u32(got[1]), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    _, _, _, r = port_gf2.gf2_eliminate(i32(Ht), i32(s), n)
    assert np.array_equal(r.numpy(), np.asarray(want[3]))
    launches = cuda_gf2.gf2_eliminate_cuda.launches
    for a, b in zip(cuda_gf2.gf2_eliminate_cuda(i32(Ht), i32(s), n), got):
        assert torch.equal(a, b)
    assert cuda_gf2.gf2_eliminate_cuda.launches == launches


def dense_elimination_work(H, n, resid=None, bp=None):
    """(trips, row XORs, words) of one lane's elimination on a dense 0/1
    matrix, in plain numpy: the full elimination, or OSD-0's with its early
    stop.  A row XOR needs the packed words from the pivot's on and the
    syndrome bit, since the pivot row is zero before column j's word."""
    H = H.astype(np.uint8).copy()
    m = H.shape[0]
    W = (n + 31) // 32
    used = np.zeros(m, bool)
    s = None if resid is None else resid.astype(np.uint8).copy()
    trips = xors = words = 0
    for j in range(n):
        if (used.all() if s is None else not (s.astype(bool) & ~used).any()):
            break
        trips += 1
        col = H[:, j].astype(bool)
        free = np.flatnonzero(col & ~used)
        if free.size == 0:
            continue
        k = free[0]
        assert not H[k, :32 * (j // 32)].any()
        if s is not None and bp[j]:
            s ^= col
        others = col.copy()
        others[k] = False
        xors += int(others.sum())
        words += int(others.sum()) * (W - j // 32 + 1)
        H[others] ^= H[k]
        if s is not None:
            s[others] ^= s[k]
        used[k] = True
    return trips, xors, words


@pytest.mark.parametrize("B,m,n,dens", [(4, 60, 80, 0.3), (3, 90, 130, 0.08), (3, 31, 33, 0.5)])
def test_elimination_work_counts(B, m, n, dens):
    """``return_work`` leaves the results as they are and counts the trips
    and row XORs that a dense numpy elimination of the same lanes makes."""
    rng = np.random.default_rng(11 + m)
    H, _, Ht = packed_systems(rng, B, m, n, dens)
    s = (rng.random((B, m)) < 0.5).astype(np.uint32)
    bp = (rng.random((B, n)) < 0.2).astype(np.uint32)
    resid = (np.einsum("bmn,bn->bm", H, (rng.random((B, n)) < 0.1)) % 2).astype(np.uint32)
    resid[0] = rng.random(m) < 0.5
    plain = port_gf2.gf2_eliminate(i32(Ht), i32(s), n)
    *same, work = port_gf2.gf2_eliminate(i32(Ht), i32(s), n, return_work=True)
    assert all(torch.equal(a, b) for a, b in zip(plain, same))
    want = [dense_elimination_work(H[b], n) for b in range(B)]
    assert [tuple(int(c) for c in lane) for lane in zip(*work)] == want
    corr, work = port_gf2.gf2_osd0(i32(Ht), i32(resid), i32(bp), n, return_work=True)
    assert torch.equal(corr, port_gf2.gf2_osd0(i32(Ht), i32(resid), i32(bp), n))
    want = [dense_elimination_work(H[b], n, resid[b], bp[b]) for b in range(B)]
    assert [tuple(int(c) for c in lane) for lane in zip(*work)] == want
    assert min(t for t, *_ in want) < n  # OSD-0 stops early on these


@pytest.mark.parametrize("w", [0, 1, 2, 3, 5])
def test_osdw_sweep_matches_reference(w):
    rng = np.random.default_rng(20 + w)
    B, m, n = 4, 40, 56
    _, _, Ht = packed_systems(rng, B, m, n, 0.15)
    s = (rng.random((B, m)) < 0.5).astype(np.uint32)
    bp = (rng.random((B, n)) < 0.2).astype(np.uint32)
    Ht2, s2, piv, r = jax.vmap(lambda ht, sv: ref_gf2.gf2_eliminate(ht, sv, n))(
        Ht, jnp.asarray(s))
    want = jax.vmap(lambda a, b, c, d, e: ref_gf2.osdw_sweep(a, b, c, d, e, w, n))(
        Ht2, s2, piv, r, jnp.asarray(bp))
    got = port_gf2.osdw_sweep(i32(Ht2), i32(s2), torch.as_tensor(np.array(piv)),
                              torch.as_tensor(np.array(r)), i32(bp), w, n)
    assert np.array_equal(got.numpy(), np.asarray(want))


def orders(logp_ref, logp_port):
    """Each package's per-lane reliability order, from its own logp."""
    rel_ref = jnp.maximum(jnp.exp(jnp.asarray(logp_ref)), 1.0 - jnp.exp(jnp.asarray(logp_ref)))
    perm_ref = np.asarray(jnp.argsort(-rel_ref, axis=1, stable=True))
    probs = torch.exp(torch.tensor(np.asarray(logp_port)))
    perm = torch.argsort(-torch.maximum(probs, 1.0 - probs), dim=1, stable=True).numpy()
    return perm_ref, perm, np.asarray(rel_ref)


def tie_lanes(logp_ref, logp_port):
    """Lanes whose column order differs between the packages; each must be
    a reliability tie (the swapped columns' reliabilities within 4 ulps)."""
    perm_ref, perm, rel = orders(logp_ref, logp_port)
    lanes = np.flatnonzero((perm_ref != perm).any(axis=1))
    for b in lanes:
        pos = np.flatnonzero(perm_ref[b] != perm[b])
        r = rel[b][np.concatenate([perm_ref[b][pos], perm[b][pos]])]
        assert np.ptp(r) <= 4 * np.spacing(np.float32(r.max())), f"lane {b} is not a tie"
    return lanes


def assert_lanes_equal(want, got, H, syns, ties, what):
    assert got.shape == want.shape
    bad = np.flatnonzero((want.astype(np.int64) != got.astype(np.int64)).any(axis=1))
    assert set(bad) <= set(ties), f"{what}: lanes {sorted(set(bad) - set(ties))} differ"
    assert len(ties) <= max(1, len(want) // 4), f"{what}: too many tie lanes {ties}"
    assert (((got.astype(np.int64) @ H.T) % 2) == syns).all(), f"{what}: not syndrome-consistent"


@pytest.mark.parametrize("order", [0, 2])
def test_osd_stage_matches_reference_on_identical_bp_outputs(order):
    """Both packages' OSD post-processors and the golden OSD, fed the same
    (syndrome, bp_err, logp) from few-iteration BP, as tests/test_bposd.py:68
    feeds the golden."""
    H = lt.parity_check_matrix(240, 8, 4, rng=17)
    rng = np.random.default_rng(5)
    B = 16
    errs = rng.random((B, H.shape[1])) < 0.15
    syns = ((errs @ H.T) % 2).astype(np.uint8)
    bp_err, conv, _, aux, _ = lt.BeliefPropagationDecoder(H, 0.15, 4).batch_decode_detailed(syns)
    logp = np.asarray(aux["log_probabs"])
    assert not conv.any()

    graph = lt.TannerGraph.from_pcm(H)
    osd0, osdw = ref_make_osd_fns(graph, order)
    ref_fn = osd0 if order == 0 else osdw
    want = np.asarray(jax.jit(ref_fn)(jnp.asarray(syns), jnp.asarray(bp_err), jnp.asarray(logp)))
    port0, portw = make_osd_fns(pt.TannerGraph.from_arrays(**dataclasses.asdict(graph)), order,
                                device="cpu")
    port_fn = port0 if order == 0 else portw
    got = port_fn(torch.tensor(syns), torch.tensor(bp_err), torch.tensor(logp)).numpy()
    ties = tie_lanes(logp, logp)
    assert_lanes_equal(want, got, H, syns, ties, f"OSD-{order} vs reference")
    golden = np.stack([golden_osd(H, syns[b], bp_err[b], logp[b], osd_order=order)
                       for b in range(B)])
    assert_lanes_equal(golden, got, H, syns, ties, f"OSD-{order} vs golden")


@pytest.mark.parametrize("order", [0, 2])
@pytest.mark.parametrize("code,per,iters", [((120, 6, 3, 51), 0.06, 30),
                                            ((240, 8, 4, 17), 0.15, 20)])
def test_bposd_decoder_matches_reference(order, code, per, iters):
    """End to end through batch_decode, with lanes that fail BP."""
    n, wr, wc, seed = code
    H = lt.parity_check_matrix(n, wr, wc, rng=seed)
    rng = np.random.default_rng(seed)
    B = 16
    errs = rng.random((B, n)) < per
    syns = ((errs @ H.T) % 2).astype(np.uint8)
    ref = lt.BeliefPropagationOSDDecoder(H, per, iters, osd_order=order)
    port = pt.BeliefPropagationOSDDecoder(H, per, iters, osd_order=order, device="cpu")
    g_ref, c_ref = ref.batch_decode(syns)
    g, c = port.batch_decode(syns)
    assert g.dtype == np.int8
    assert np.array_equal(c, c_ref)
    assert not c.all(), "the case needs lanes that fail BP"
    _, _, _, a_ref, _ = lt.BeliefPropagationDecoder(H, per, iters).batch_decode_detailed(syns)
    _, _, _, a_port, _ = pt.BeliefPropagationDecoder(
        H, per, iters, device="cpu").batch_decode_detailed(syns)
    ties = tie_lanes(np.asarray(a_ref["log_probabs"]), a_port["log_probabs"])
    assert_lanes_equal(g_ref, g, H, syns, ties, f"BP+OSD-{order}")


INNER_VARIANTS = {
    "minsum": lambda mk: dict(inner="minsum"),
    "minsum_damped": lambda mk: dict(inner="minsum", damping=0.5),
    "instance": lambda mk: dict(inner=mk(alpha=0.8, check_every=2)),
    "minsum_failed_scope": lambda mk: dict(inner="minsum", osd_scope="failed"),
    "sumproduct_failed_scope": lambda mk: dict(osd_scope="failed"),
}


@pytest.mark.parametrize("order", [0, 2])
@pytest.mark.parametrize("variant", list(INNER_VARIANTS))
def test_bposd_inner_and_scope_match_reference(order, variant):
    """``inner=`` (by name, damped, or a constructed MinSumDecoder) and
    ``osd_scope="failed"``, end to end through batch_decode with lanes that
    fail the inner decoder; bitwise but for reliability ties."""
    n, wr, wc, seed = 240, 8, 4, 17
    per, iters, B = 0.055, 20, 16
    H = lt.parity_check_matrix(n, wr, wc, rng=seed)
    rng = np.random.default_rng(seed)
    errs = rng.random((B, n)) < per
    syns = ((errs @ H.T) % 2).astype(np.uint8)
    kw_ref = INNER_VARIANTS[variant](lambda **kw: lt.MinSumDecoder(H, per, iters, **kw))
    kw_port = INNER_VARIANTS[variant](
        lambda **kw: pt.MinSumDecoder(H, per, iters, device="cpu", **kw))
    ref = lt.BeliefPropagationOSDDecoder(H, per, iters, osd_order=order, **kw_ref)
    port = pt.BeliefPropagationOSDDecoder(H, per, iters, osd_order=order, device="cpu",
                                          **kw_port)
    # built-in prior, then a per-call override, which goes through the
    # inner decoder's own prior domain (ratio for BP, LLR for min-sum)
    for override in (None, 0.04):
        g_ref, c_ref, i_ref, a_ref, _ = ref.batch_decode_detailed(syns, per=override)
        g, c, i, a, _ = port.batch_decode_detailed(syns, per=override)
        assert g.dtype == np.int8 and set(a) == {"log_probabs"}
        assert np.array_equal(c, c_ref) and np.array_equal(i, i_ref)
        assert c.any() and not c.all(), "the case needs lanes that fail and that converge"
        ties = tie_lanes(np.asarray(a_ref["log_probabs"]), a["log_probabs"])
        assert_lanes_equal(g_ref, g, H, syns, ties, f"BP+OSD-{order} {variant}")
    if "failed" in variant:  # converged lanes keep the inner decoder's output
        inner = (pt.MinSumDecoder if "minsum" in variant else pt.BeliefPropagationDecoder)(
            H, per, iters, device="cpu")
        assert np.array_equal(g[c], inner.batch_decode(syns, per=0.04)[0][c])


def test_bposd_damped_minsum_inner_small_case():
    """The case of tests/test_minsum.py:96 (toric code, damping 0.3): the
    port equals the reference's compacting and fused decoders."""
    H = lt.toric_code_x(3)
    syn = np.zeros((4, 9), np.uint8)
    syn[1, 2] = 1
    syn[1, 5] = 1
    for damping in (0.3, 0.4):
        ref = lt.BeliefPropagationOSDDecoder(H, 0.05, 30, inner="minsum", damping=damping)
        port = pt.BeliefPropagationOSDDecoder(H, 0.05, 30, inner="minsum", damping=damping,
                                              device="cpu")
        e_r, c_r = ref.batch_decode(syn)
        e_p, c_p = port.batch_decode(syn)
        assert np.array_equal(e_r, e_p) and np.array_equal(c_r, c_p)
        assert (((e_p.astype(np.uint8) @ H.T) & 1) == syn).all()
        assert port.damping == damping


def test_bposd_options_and_validation():
    H = lt.parity_check_matrix(60, 6, 3, rng=19)
    make = lambda *a, **kw: pt.BeliefPropagationOSDDecoder(*a, device="cpu", **kw)  # noqa: E731
    assert make(H, 0.1, 10, fused=True).fused  # builds, as the reference's does
    with pytest.raises(ValueError, match="fused=True cannot trace it"):
        make(H, 0.1, 10, fused=True, osd_impl="host")
    cs = make(H, 0.1, 10, osd_method="combination_sweep", osd_order=500)
    assert cs.osd_order == H.shape[1] and cs.osd is not None  # no rank clamp
    assert make(H, 0.1, 10, osd_impl="host").osd is None  # the host OSD packs its own
    with pytest.raises(ValueError, match="osd_order=0"):
        make(H, 0.1, 10, osd_impl="host", osd_order=2)
    with pytest.raises(ValueError, match="osd_triples"):
        make(H, 0.1, 10, osd_triples=3)
    with pytest.raises(ValueError, match="min-sum knob"):
        make(H, 0.1, 10, damping=0.3)
    with pytest.raises(TypeError, match="inner must be"):
        make(H, 0.1, 10, inner=pt.BeliefPropagationDecoder(H, 0.1, 10, device="cpu"))
    with pytest.raises(TypeError, match="inner must be"):
        make(H, 0.1, 10, inner="bogus")
    other = pt.MinSumDecoder(lt.parity_check_matrix(120, 6, 3, rng=51), 0.1, 10, device="cpu")
    with pytest.raises(ValueError, match="inner decoder is built on"):
        make(H, 0.1, 10, inner=other)
    for kw, match in ((dict(osd_scope="bogus"), "osd_scope"),
                      (dict(osd_method="bogus"), "osd_method"),
                      (dict(osd_impl="bogus"), "osd_impl"),
                      (dict(osd_order=-1), "osd_order")):
        with pytest.raises(ValueError, match=match):
            make(H, 0.1, 10, **kw)
    with pytest.raises(ValueError, match="dense parity-check"):
        make(pt.TannerGraph.from_edges(*np.nonzero(H), *H.shape), 0.1, 10)
    hamming = np.array([[1, 0, 1, 0, 1, 0, 1],
                        [0, 1, 1, 0, 0, 1, 1],
                        [0, 0, 0, 1, 1, 1, 1]], np.uint8)  # rank 3, n 7
    with pytest.warns(UserWarning, match="clamping"):
        dec = make(hamming, 0.05, 10, osd_order=6)
    assert dec.osd_order == 4
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert make(hamming, 0.05, 10, osd_order=4).osd_order == 4


def test_bposd_per_override_and_single_decode():
    H = lt.parity_check_matrix(120, 6, 3, rng=51)
    rng = np.random.default_rng(8)
    errs = rng.random((8, 120)) < 0.08
    syns = ((errs @ H.T) % 2).astype(np.uint8)
    built = pt.BeliefPropagationOSDDecoder(H, 0.08, 20, device="cpu").batch_decode(syns)
    over = pt.BeliefPropagationOSDDecoder(H, 0.01, 20, device="cpu")
    g, c = over.batch_decode(syns, per=0.08)
    assert np.array_equal(g, built[0]) and np.array_equal(c, built[1])
    assert np.array_equal(over.decode(syns[3], per=0.08)[0], g[3])
    assert (((g.astype(np.int64) @ H.T) % 2) == syns).all()


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the CPU-only refusal")
    H = lt.parity_check_matrix(60, 6, 3, rng=19)
    with pytest.raises(RuntimeError, match="cuda"):
        pt.BeliefPropagationOSDDecoder(H, 0.05, 10, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        pt.BeliefPropagationDecoder(H, 0.05, 10, device="cuda")


def test_kernel_wrappers_refuse_other_devices_and_oversized_lanes():
    n, m = 64, 20
    Ht = torch.zeros((2, 2, m), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_gf2.gf2_osd0_cuda(Ht, Ht[:, 0], torch.zeros((2, n), dtype=torch.int32,
                                                         device="meta"), n)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_gf2.gf2_eliminate_cuda(Ht, Ht[:, 0], n)
    # the reference benchmark's lane fits one Hopper block; the bb144
    # circuit-level DEM (864 x 31,648) does not
    assert cuda_gf2.smem_bytes(32, 900, osd0=True) <= cuda_gf2.MAX_SMEM_BYTES
    assert cuda_gf2.smem_bytes((31648 + 31) // 32, 864, osd0=False) > cuda_gf2.MAX_SMEM_BYTES


@pytest.mark.parametrize("lam", [0, 1, 2, 7, 80])
def test_osd_cs_sweep_matches_reference(lam):
    """OSD-CS over the same RREF systems: ``osd_cs_sweep`` and the whole
    ``gf2_osd_cs`` bitwise against the reference's (``lam`` past the
    information set is masked)."""
    rng = np.random.default_rng(40 + lam)
    B, m, n = 5, 40, 70
    _, Hp, Ht = packed_systems(rng, B, m, n, 0.12)
    s = (rng.random((B, m)) < 0.5).astype(np.uint32)
    bp = (rng.random((B, n)) < 0.2).astype(np.uint32)
    Ht2, s2, piv, r = jax.vmap(lambda ht, sv: ref_gf2.gf2_eliminate(ht, sv, n))(
        Ht, jnp.asarray(s))
    want = jax.vmap(lambda a, b, c, d, e: ref_gf2.osd_cs_sweep(a, b, c, d, e, lam, n))(
        Ht2, s2, piv, r, jnp.asarray(bp))
    got = port_gf2.osd_cs_sweep(i32(Ht2), i32(s2), torch.as_tensor(np.array(piv)),
                                torch.as_tensor(np.array(r)), i32(bp), lam, n)
    assert np.array_equal(got.numpy(), np.asarray(want))
    whole = jax.vmap(lambda h, b, sy: ref_gf2.gf2_osd_cs(h, b, sy, lam, n))(
        Hp, jnp.asarray(bp), jnp.asarray(s))
    assert np.array_equal(port_gf2.gf2_osd_cs(i32(Ht), i32(bp), i32(s), lam, n).numpy(),
                          np.asarray(whole))


CS_VARIANTS = {
    "device": dict(osd_method="combination_sweep", osd_order=10),
    "device_failed_scope": dict(osd_method="combination_sweep", osd_order=10,
                                osd_scope="failed", inner="minsum"),
    "host_osd0": dict(osd_impl="host"),
    "host_osd0_failed_scope": dict(osd_impl="host", osd_scope="failed", inner="minsum"),
    "host_cs": dict(osd_impl="host", osd_method="combination_sweep", osd_order=10),
    "host_cs_triples": dict(osd_impl="host", osd_method="combination_sweep", osd_order=10,
                            osd_triples=6, inner="minsum"),
}


@pytest.mark.parametrize("variant", list(CS_VARIANTS))
def test_bposd_cs_and_host_match_reference(variant):
    """BP+OSD-CS on the device and the host OSD (OSD-0, OSD-CS, with
    triples), end to end with lanes that fail the inner decoder: bitwise
    but for reliability ties (shown per lane)."""
    n, wr, wc, seed = 240, 8, 4, 17
    per, iters, B = 0.055, 20, 16
    H = lt.parity_check_matrix(n, wr, wc, rng=seed)
    rng = np.random.default_rng(seed + 1)
    syns = (((rng.random((B, n)) < per) @ H.T) % 2).astype(np.uint8)
    kw = CS_VARIANTS[variant]
    ref = lt.BeliefPropagationOSDDecoder(H, per, iters, **kw)
    port = pt.BeliefPropagationOSDDecoder(H, per, iters, device="cpu", **kw)
    assert (port.osd is None) == variant.startswith("host")
    g_ref, c_ref, i_ref, a_ref, _ = ref.batch_decode_detailed(syns)
    g, c, i, a, _ = port.batch_decode_detailed(syns)
    assert g.dtype == np.int8
    assert np.array_equal(c, c_ref) and np.array_equal(i, i_ref)
    assert c.any() and not c.all(), "the case needs lanes that fail and that converge"
    ties = tie_lanes(np.asarray(a_ref["log_probabs"]), a["log_probabs"])
    assert_lanes_equal(g_ref, g, H, syns, ties, f"BP+OSD {variant}")


def test_lanes_past_shared_memory_take_the_host_osd():
    """A lane too large for one block of the elimination kernels takes the
    host OSD where the caller asks for it (OSD-0 and OSD-CS), equal to the
    reference's ``osd_impl="host"``; the device OSD constructs there too
    (OSD-0, OSD-CS and the exhaustive OSD-w: the kernels' device-memory
    body) and its OSD-0 decodes equal to the host OSD-0 (the three device
    orders against the reference: tests/test_torch_gf2_global.py)."""
    H = lt.parity_check_matrix(2000, 10, 5, rng=3)  # m=1000: W*m*4 > 232,448 B
    W, m = (H.shape[1] + 31) // 32, H.shape[0]
    assert cuda_gf2.launch_plan(W, m, osd0=True).panel == 0
    assert cuda_gf2.launch_plan(W, m, osd0=False).panel == 0
    assert cuda_gf2.route(W, m, osd0=True) == cuda_gf2.route(W, m, osd0=False) == "global"
    for kw in (dict(osd_order=2), dict(osd_method="combination_sweep", osd_order=8)):
        assert pt.BeliefPropagationOSDDecoder(H, 0.03, 10, device="cpu", **kw).osd is not None
    rng = np.random.default_rng(4)
    syns = (((rng.random((6, H.shape[1])) < 0.07) @ H.T) % 2).astype(np.uint8)
    dev = pt.BeliefPropagationOSDDecoder(H, 0.03, 10, device="cpu")
    host = pt.BeliefPropagationOSDDecoder(H, 0.03, 10, device="cpu", osd_impl="host")
    assert np.array_equal(dev.batch_decode(syns)[0], host.batch_decode(syns)[0])
    for kw in (dict(), dict(osd_method="combination_sweep", osd_order=8)):
        port = pt.BeliefPropagationOSDDecoder(H, 0.03, 10, device="cpu", osd_impl="host", **kw)
        ref = lt.BeliefPropagationOSDDecoder(H, 0.03, 10, osd_impl="host", **kw)
        g_ref, c_ref = ref.batch_decode(syns)
        g, c = port.batch_decode(syns)
        assert np.array_equal(c, c_ref) and not c.all()
        ties = tie_lanes(np.asarray(lt.BeliefPropagationDecoder(H, 0.03, 10).batch_decode_detailed(
            syns)[3]["log_probabs"]), pt.BeliefPropagationDecoder(
                H, 0.03, 10, device="cpu").batch_decode_detailed(syns)[3]["log_probabs"])
        assert_lanes_equal(g_ref, g, H, syns, ties, f"routed host OSD {kw}")
