"""Port parity: the carried numpy modules of the CSS and circuit-level
tier, and ``CSSDecoder``.

``codes/css.py``, ``codes/circuit.py``, ``utils/metrics.py``,
``utils/noise.py`` and ``utils/io.py`` are the port's own copies of the JAX
package's numpy modules: every matrix, DEM triple, DEM text, circuit draw,
metric and file is held bitwise against the original.  ``CSSDecoder`` (with
and without heralded loss, ``erasures=``) decodes exactly as the JAX
package's on the same syndromes, with tests/test_torch_bposd.py's one
allowance: torch's float32 ``exp``/``log`` can differ from XLA's by an ulp,
so on a code as symmetric as the toric code an OSD lane whose column
reliabilities tie within 4 ulps may take another (syndrome-consistent)
solution; such a lane is shown to be a tie, every other lane is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.utils import io as ref_io
from ldpcdecoders_tpu.utils import metrics as ref_metrics
from ldpcdecoders_tpu.utils import noise as ref_noise
from ldpcdecoders_tpu_torch import utils as port_utils
from ldpcdecoders_tpu_torch.utils import noise as port_noise

torch.set_num_threads(1)


def same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if sp.issparse(a):
        return sp.issparse(b) and a.shape == b.shape and (a != b).nnz == 0 and a.dtype == b.dtype
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


CODES = [("toric_code_x", 3), ("toric_code_z", 4), ("surface_code_x", 5),
         ("surface_code_z", 3), ("repetition_code", 7), ("cycle_matrix", 6),
         ("hamming_code", 4)]


@pytest.mark.parametrize("name,arg", CODES)
def test_css_codes_bitwise(name, arg):
    assert same(getattr(pt, name)(arg), getattr(lt, name)(arg))


def test_hypergraph_products_bitwise():
    H1, H2 = lt.repetition_code(3), lt.hamming_code(3)
    assert same(pt.hypergraph_product(H1, H2), lt.hypergraph_product(H1, H2))
    assert same(pt.hypergraph_product_edges(H1, H2), lt.hypergraph_product_edges(H1, H2))
    coo = (np.array([0, 1]), np.array([1, 2]), 2, 3)
    assert same(pt.hypergraph_product_edges(coo, H2), lt.hypergraph_product_edges(coo, H2))
    with pytest.raises(ValueError, match="odd distance"):
        pt.surface_code_x(4)


@pytest.mark.parametrize("d,R,p,basis", [(3, 3, 0.005, "z"), (3, 2, 0.01, "x")])
def test_circuit_dem_text_and_draws_bitwise(d, R, p, basis):
    Hx, Hz = lt.surface_code_x(d), lt.surface_code_z(d)
    rc = lt.css_memory_circuit(Hx, Hz, R, p=p, basis=basis)
    pc = pt.css_memory_circuit(Hx, Hz, R, p=p, basis=basis)
    assert (pc.n_qubits, pc.n_meas, pc.detectors, pc.observables) == (
        rc.n_qubits, rc.n_meas, rc.detectors, rc.observables)
    assert len(pc.ops) == len(rc.ops)
    for a, b in zip(pc.ops, rc.ops):
        assert a[0] == b[0] and all(same(x, y) for x, y in zip(a[1:], b[1:]))
    assert same(pt.circuit_dem(pc), lt.circuit_dem(rc))
    assert pt.dem_text(pc) == lt.dem_text(rc)
    assert pt.dem_text(pc, precision=6) == lt.dem_text(rc, precision=6)
    for seed in (0, 7):
        assert same(pt.sample_circuit(pc, 200, seed=seed), lt.sample_circuit(rc, 200, seed=seed))
    # the port's DEM parser reads the text back to the same model
    A, pr, O = pt.load_dem(pt.dem_text(pc))
    A_r, pr_r, O_r = lt.circuit_dem(rc)
    assert (A != A_r).nnz == 0 and np.allclose(pr, pr_r, rtol=1e-11) and np.array_equal(O, O_r)


def test_stabilizer_circuit_refusals():
    c = pt.StabilizerCircuit(4)
    with pytest.raises(ValueError, match="out of range"):
        c.h([4])
    with pytest.raises(ValueError, match="reuses a qubit"):
        c.cx([0, 1], [1, 2])
    with pytest.raises(ValueError, match="CSS pair"):
        pt.css_memory_circuit(lt.repetition_code(3), lt.repetition_code(3), 1)


def test_metrics_bitwise():
    Hx, Hz = lt.toric_code_x(3), lt.toric_code_z(3)
    rng = np.random.default_rng(4)
    errs = rng.random((64, Hx.shape[1])) < 0.1
    guesses = errs ^ (rng.random(errs.shape) < 0.05)
    syns = (errs.astype(int) @ Hx.T) % 2
    for name, args in (("exact_recovery_ler", (guesses, errs)),
                       ("syndrome_match_rate", (Hx, guesses, syns)),
                       ("logical_failure_rate", (Hz, errs, guesses)),
                       ("gf2_kernel_basis", (Hx,)),
                       ("css_logical_operators", (Hx, Hz)),
                       ("css_logical_operators", (sp.csr_matrix(Hz), Hx)),
                       ("wilson_interval", (7, 100))):
        assert same(getattr(port_utils, name)(*args), getattr(ref_metrics, name)(*args)), name
    resid = errs ^ guesses
    for H in (Hz, sp.csr_matrix(Hx)):
        assert same(port_utils.gf2_rowspan_reducer(H)(resid),
                    ref_metrics.gf2_rowspan_reducer(H)(resid))
    bb_x, bb_z, _ = lt.named_bicycle_code("bb144")[:3]
    L = port_utils.css_logical_operators(bb_x, bb_z)
    assert L.shape == (12, 144) and same(L, ref_metrics.css_logical_operators(bb_x, bb_z))


def test_noise_bitwise():
    H = lt.parity_check_matrix(120, 6, 3, rng=5)
    errs = port_noise.sample_errors(np.random.default_rng(3), 40, 120, 0.05)
    assert same(errs, ref_noise.sample_errors(np.random.default_rng(3), 40, 120, 0.05))
    assert same(port_noise.sample_errors(9, 4, 120, 0.5), ref_noise.sample_errors(9, 4, 120, 0.5))
    for Hm in (H, sp.csr_matrix(H)):
        assert same(port_noise.syndromes_of(Hm, errs), ref_noise.syndromes_of(Hm, errs))
    guesses = errs ^ (np.random.default_rng(1).random(errs.shape) < 0.02)
    assert same(port_noise.verify_decodes(H, errs, guesses),
                ref_noise.verify_decodes(H, errs, guesses))
    r, c = np.nonzero(H)
    assert same(port_noise.syndromes_from_edges(errs, r, c, H.shape[0]),
                ref_noise.syndromes_from_edges(errs, r, c, H.shape[0]))
    assert same(port_noise.sample_mixed_channel(np.random.default_rng(2), 8, 120, 0.01, 0.1),
                ref_noise.sample_mixed_channel(np.random.default_rng(2), 8, 120, 0.01, 0.1))


def test_device_draws_repeat_for_a_seed():
    a = port_noise.sample_errors_device(11, 2000, 300, 0.1, device="cpu")
    b = port_noise.sample_errors_device(11, 2000, 300, 0.1, device="cpu")
    c = port_noise.sample_errors_device(12, 2000, 300, 0.1, device="cpu")
    assert a.dtype == torch.bool and a.shape == (2000, 300)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(a.float().mean().item() - 0.1) < 0.003  # 600,000 draws: 7 sigma
    gen = torch.Generator()
    gen.manual_seed(11)
    assert torch.equal(port_noise.sample_errors_device(gen, 2000, 300, 0.1), a)


def test_io_round_trips_across_packages(tmp_path):
    H = lt.parity_check_matrix(60, 6, 3, rng=1)
    port_utils.save_code_npz(str(tmp_path / "p"), H, wr=np.array(6))
    ref_io.save_code_npz(str(tmp_path / "r.npz"), H, wr=np.array(6))
    for loader, path in ((ref_io.load_code_npz, "p.npz"), (port_utils.load_code_npz, "r"),
                         (port_utils.load_code_npz, "p")):
        H2, meta = loader(str(tmp_path / path))
        assert same(H2, H) and int(meta["wr"]) == 6
    g = pt.TannerGraph.from_pcm(H)
    port_utils.save_graph_npz(str(tmp_path / "g"), g)
    back = ref_io.load_graph_npz(str(tmp_path / "g"))
    ref_io.save_graph_npz(str(tmp_path / "gr"), back)
    again = port_utils.load_graph_npz(str(tmp_path / "gr"))
    assert isinstance(again, pt.TannerGraph)
    for f in ("chk_vars", "chk_mask", "var_chks", "var_mask", "c2v_gather", "v2c_gather", "H"):
        assert np.array_equal(getattr(again, f), getattr(g, f)), f
    port_utils.atomic_write_json(str(tmp_path / "c.json"), {"a": [1, 2]})
    assert ref_io.read_json(str(tmp_path / "c.json")) == {"a": [1, 2]}


CSS_CASES = [  # (code, decoder kind, knobs)
    ("toric3", "bposd", {}),
    ("surface5", "bposd", dict(osd_order=2)),
    ("surface5", "minsum", dict(alpha=0.8)),
]


def css_pair(name):
    if name == "toric3":
        return lt.toric_code_x(3), lt.toric_code_z(3)
    return lt.surface_code_x(5), lt.surface_code_z(5)


def tie_lanes(ref_block, port_block, syn, kw):
    """Lanes whose OSD column order differs between the packages (each
    package ranks by its own BP logp); each must be a reliability tie."""
    lp_ref = ref_block.batch_decode_detailed(syn, **kw)[3]["log_probabs"]
    lp_port = port_block.batch_decode_detailed(syn, **kw)[3]["log_probabs"]
    rel_ref = jnp.maximum(jnp.exp(jnp.asarray(lp_ref)), 1.0 - jnp.exp(jnp.asarray(lp_ref)))
    perm_ref = np.asarray(jnp.argsort(-rel_ref, axis=1, stable=True))
    probs = torch.exp(torch.tensor(np.asarray(lp_port)))
    perm = torch.argsort(-torch.maximum(probs, 1.0 - probs), dim=1, stable=True).numpy()
    rel = np.asarray(rel_ref)
    lanes = np.flatnonzero((perm_ref != perm).any(axis=1))
    for b in lanes:
        pos = np.flatnonzero(perm_ref[b] != perm[b])
        r = rel[b][np.concatenate([perm_ref[b][pos], perm[b][pos]])]
        assert np.ptp(r) <= 4 * np.spacing(np.float32(r.max())), f"lane {b} is not a tie"
    return set(lanes.tolist())


@pytest.mark.parametrize("name,kind,knobs", CSS_CASES)
def test_css_decoder_matches_reference(name, kind, knobs):
    Hx, Hz = css_pair(name)
    rng = np.random.default_rng(6)
    z_true = rng.random((48, Hx.shape[1])) < 0.06
    x_true = rng.random((48, Hx.shape[1])) < 0.06
    sx, sz = (z_true @ Hx.T) % 2, (x_true @ Hz.T) % 2
    ref = lt.CSSDecoder(Hx, Hz, 0.06, 30, decoder=kind, **knobs)
    port = pt.CSSDecoder(Hx, Hz, 0.06, 30, decoder=kind, device="cpu", **knobs)
    assert isinstance(port, torch.nn.Module) and port.device == torch.device("cpu")
    n_ties = 0
    for kw in ({}, dict(per=0.03, seed=4)):
        z_hat, x_hat, zc, xc = port.batch_decode(sx, sz, **kw)
        w_z, w_x, w_zc, w_xc = ref.batch_decode(sx, sz, **kw)
        assert same(zc, w_zc) and same(xc, w_xc)
        per_kw = {"per": kw["per"]} if "per" in kw else {}
        for got, want, H, syn, blocks in ((z_hat, w_z, Hx, sx, (ref.x_block, port.x_block)),
                                          (x_hat, w_x, Hz, sz, (ref.z_block, port.z_block))):
            assert got.dtype == want.dtype
            bad = set(np.flatnonzero((got != want).any(axis=1)).tolist())
            if bad:
                assert kind == "bposd" and bad <= tie_lanes(*blocks, syn, per_kw)
                n_ties += len(bad)
                assert ((got.astype(np.int64) @ H.T) % 2 == syn).all()
    assert n_ties <= 4
    z_hat, x_hat, _, _ = port.batch_decode(sx, sz)
    w_z, w_x, _, _ = ref.batch_decode(sx, sz)
    # logical failures agree lane for lane where the estimates do
    same_lanes = (z_hat == w_z).all(axis=1) & (x_hat == w_x).all(axis=1)
    got_f = port.logical_failures(z_true, z_hat, x_true, x_hat)
    want_f = ref.logical_failures(z_true, w_z, x_true, w_x)
    for g, w in zip(got_f, want_f):
        assert np.array_equal(g[same_lanes], w[same_lanes])
    assert same(port.logical_failures(z_true, w_z, x_true, w_x), want_f)
    assert same(port.decode(sx[0], sz[0])[0], ref.decode(sx[0], sz[0])[0])


def test_css_decoder_heralded_loss_matches_reference():
    Hx, Hz = lt.surface_code_x(5), lt.surface_code_z(5)
    rng = np.random.default_rng(8)
    eps = rng.random((40, 25)) < 0.1
    z_true = np.where(eps, rng.random((40, 25)) < 0.5, rng.random((40, 25)) < 0.03)
    x_true = np.where(eps, rng.random((40, 25)) < 0.5, rng.random((40, 25)) < 0.03)
    sx, sz = (z_true @ Hx.T) % 2, (x_true @ Hz.T) % 2
    ref = lt.CSSDecoder(Hx, Hz, 0.03, 30)
    port = pt.CSSDecoder(Hx, Hz, 0.03, 30, device="cpu")
    for kw in (dict(erasures=eps), dict(erasures=eps, per=0.02, seed=3)):
        for g, w in zip(port.batch_decode(sx, sz, **kw), ref.batch_decode(sx, sz, **kw)):
            assert same(g, w)
    with pytest.raises(ValueError, match="erasures of shape"):
        port.batch_decode(sx, sz, erasures=eps[:, :5])


def test_css_decoder_refusals():
    Hx, Hz = lt.toric_code_x(3), lt.toric_code_z(3)
    with pytest.raises(ValueError, match="CSS condition"):
        pt.CSSDecoder(Hx, Hx, 0.01, 10, device="cpu")
    with pytest.raises(ValueError, match="same qubits"):
        pt.CSSDecoder(Hx, Hz[:, :-1], 0.01, 10, device="cpu")
    bf = pt.CSSDecoder(Hx, Hz, 0.01, 10, decoder="bitflip", device="cpu")
    with pytest.raises(ValueError, match="erasure"):
        bf.batch_decode(np.zeros((2, 9)), np.zeros((2, 9)), erasures=np.zeros((2, 18), bool))
    with pytest.raises(ValueError, match="per-qubit prior"):
        pt.CSSDecoder(Hx, Hz, np.full(18, 0.01), 10, decoder="bitflip", device="cpu")
    with pytest.raises(ValueError, match="pair up"):
        pt.CSSDecoder(Hx, Hz, 0.01, 10, device="cpu").batch_decode(np.zeros((2, 9)),
                                                                   np.zeros((3, 9)))
