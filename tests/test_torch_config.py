"""Port parity: ``DecoderConfig`` and the device-memory model.

A configuration serialized by ``ldpcdecoders_tpu`` (``to_json``) is the
"weights" of a decoder: the port's ``DecoderConfig`` has the same fields
and defaults and writes the same JSON text, and a config from the JAX
package builds port decoders that decode exactly as port decoders built
directly (bitwise in every output); every kind of the reference builds.
``utils/hbm.py``'s lane ceilings equal the reference's under an explicit
``hbm_bytes=``, given the headroom the port measured on the card.
"""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.utils import hbm as ref_hbm
from ldpcdecoders_tpu_torch.config import PORTED_KINDS
from ldpcdecoders_tpu_torch.utils import hbm

torch.set_num_threads(1)

CONFIGS = [
    dict(kind="bp", per=0.03, max_iters=20),
    dict(kind="bitflip", per=0.03, max_iters=25),
    dict(kind="bpots", per=0.05, max_iters=30, T=5, C=1.5),
    dict(kind="bposd", per=0.05, max_iters=15, osd_order=4, osd_method="combination_sweep",
         inner="minsum", damping=0.25, osd_scope="failed"),
    dict(kind="minsum", per=0.04, max_iters=25, alpha=0.8, beta=0.1),
    dict(kind="qc_minsum", per=0.04, max_iters=12, schedule="layered", backend="auto"),
    dict(kind="spacetime", per=0.02, max_iters=20, rounds=2, inner_kind="minsum", damping=0.3),
    dict(kind="detector", per=0.01, max_iters=20, inner_kind="bposd", osd_impl="host"),
    dict(kind="ensemble", members=(dict(kind="minsum", per=0.04, max_iters=20, damping=0.1),
                                   dict(kind="minsum", per=0.04, max_iters=20, damping=0.5))),
    dict(kind="staged", per=0.003, max_iters=40, gammas=(0.4, [-0.2, 0.6]), stage0_iters=16,
         relay_legs=1, lam=12, lam3=4, deep_dtype="bf16"),
]


@pytest.mark.parametrize("kw", CONFIGS, ids=[c["kind"] for c in CONFIGS])
def test_json_text_is_the_reference_text(kw):
    ref = lt.DecoderConfig(**kw)
    port = pt.DecoderConfig(**kw)
    assert port.to_json() == ref.to_json()
    assert pt.DecoderConfig.from_json(ref.to_json()) == port
    assert lt.DecoderConfig.from_json(port.to_json()) == ref
    assert [f.name for f in dataclasses.fields(pt.DecoderConfig)] == [
        f.name for f in dataclasses.fields(lt.DecoderConfig)]
    assert json.loads(port.to_json())["members"] == json.loads(ref.to_json())["members"]


def _small_dem(seed=0, D=40, N=300, k=3):
    """The small random DEM of tests/test_staged.py."""
    rng = np.random.default_rng(seed)
    A = (rng.random((D, N)) < 0.08).astype(np.uint8)
    A[:, A.sum(axis=0) == 0] = 1
    pr = np.clip(rng.random(N) * 0.01, 1e-4, 0.01)
    O = (rng.random((k, N)) < 0.1).astype(np.uint8)
    return A, pr, O


def _code_and_direct(kind):
    """The code argument of a kind and a port decoder built directly with
    the same knobs as CONFIGS' entry."""
    H = lt.parity_check_matrix(120, 6, 3, rng=51)
    cpu = dict(device="cpu")
    if kind == "bp":
        return H, pt.BeliefPropagationDecoder(H, 0.03, 20, **cpu)
    if kind == "bitflip":
        return H, pt.BitFlipDecoder(H, 0.03, 25, **cpu)
    if kind == "bpots":
        return H, pt.BPOTSDecoder(H, 0.05, 30, T=5, C=1.5, **cpu)
    if kind == "bposd":
        return H, pt.BeliefPropagationOSDDecoder(
            H, 0.05, 15, osd_order=4, osd_method="combination_sweep", inner="minsum",
            damping=0.25, osd_scope="failed", **cpu)
    if kind == "minsum":
        return H, pt.MinSumDecoder(H, 0.04, 25, alpha=0.8, beta=0.1, **cpu)
    if kind == "qc_minsum":
        base = lt.random_qc_base_matrix(8, 4, 2, 16, rng=0)
        return (base, 16), pt.QCMinSumDecoder(base, 16, 0.04, 12, schedule="layered", **cpu)
    if kind == "spacetime":
        Ht = lt.toric_code_x(3)
        return Ht, pt.SpaceTimeDecoder(Ht, 2, 0.02, 20, decoder="minsum", damping=0.3, **cpu)
    if kind == "ensemble":
        return H, pt.EnsembleDecoder([pt.MinSumDecoder(H, 0.04, 20, damping=d, **cpu)
                                      for d in (0.1, 0.5)], H=H)
    A, pr, O = _small_dem(3)
    if kind == "detector":
        return (A, pr, O), pt.DetectorGraphDecoder(A, pr, 20, observables=O, osd_impl="host",
                                                   **cpu)
    return (A, pr, O), pt.StagedDemDecoder(
        A, pr, observables=O, gammas=(0.4, (-0.2, 0.6)), stage0_iters=16, deep_iters=40,
        relay_legs=1, lam=12, lam3=4, deep_dtype=torch.bfloat16, **cpu)


@pytest.mark.parametrize("kw", CONFIGS, ids=[c["kind"] for c in CONFIGS])
def test_reference_config_builds_port_decoders(kw):
    """A config written by the JAX package builds a port decoder that
    decodes exactly as one built directly."""
    cfg = pt.DecoderConfig.from_json(lt.DecoderConfig(**kw).to_json())
    code, direct = _code_and_direct(kw["kind"])
    built = cfg.build(code, device="cpu")
    assert type(built) is type(direct) and built.device == torch.device("cpu")
    rng = np.random.default_rng(7)
    n_in = direct.m
    syn = (rng.random((12, n_in)) < 0.15).astype(np.uint8)
    got = built.batch_decode_detailed(syn)
    want = direct.batch_decode_detailed(syn)
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)


LAST_PORTED = ["minsum_int8", "layered_minsum", "neural_minsum", "window"]


def test_every_reference_kind_is_ported():
    """Every kind of the reference's ``_KINDS`` builds in the port."""
    from ldpcdecoders_tpu.config import _KINDS as REF_KINDS
    from ldpcdecoders_tpu_torch.config import _KINDS

    assert set(PORTED_KINDS) == set(_KINDS) == set(REF_KINDS)


def _last_kind_case(kind):
    """(config kwargs, code, inputs) of one of the last four kinds."""
    H = lt.parity_check_matrix(96, 6, 3, rng=11)
    rng = np.random.default_rng(3)
    if kind == "window":
        Hq = lt.toric_code_x(3)
        syn = (rng.random((6, 5, Hq.shape[0])) < 0.1).astype(np.uint8)
        syn[:, -1] = ((rng.random((6, Hq.shape[1])) < 0.1) @ Hq.T) % 2
        return dict(kind=kind, per=0.01, max_iters=20, window=3, commit=1,
                    inner_kind="minsum"), Hq, syn
    syn = (((rng.random((12, H.shape[1])) < 0.05) @ H.T) % 2).astype(np.uint8)
    extra = {"minsum_int8": dict(scale=2.0, beta_q=0), "layered_minsum": dict(damping=0.2),
             "neural_minsum": dict()}[kind]
    return dict(kind=kind, per=0.05, max_iters=10, **extra), H, syn


@pytest.mark.parametrize("kind", LAST_PORTED)
def test_last_ported_kinds_build_and_decode_as_reference(kind):
    """The four kinds this slice ported build from the reference's JSON and
    decode equal to the reference's build: int8 min-sum, the untrained
    neural schedule (flags), the window corrections and layered min-sum
    (flags; its LLRs see the reference's contracted damping mix)."""
    kw, code, syn = _last_kind_case(kind)
    built = pt.DecoderConfig.from_json(lt.DecoderConfig(**kw).to_json()).build(code,
                                                                              device="cpu")
    ref = lt.DecoderConfig(**kw).build(code)
    assert type(built).__name__ == type(ref).__name__
    if kind == "window":
        got, want = built.decode_stream(syn), ref.decode_stream(syn)
        assert np.array_equal(got[0], np.asarray(want[0]))
        assert abs(got[1]["converged"] - want[1]["converged"]) <= 1e-6
        return
    got, want = built.batch_decode_detailed(syn), ref.batch_decode_detailed(syn)
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("kw", [c for c in CONFIGS if c["kind"] in ("bitflip", "bpots")],
                         ids=["bitflip", "bpots"])
def test_json_builds_the_same_decoder_in_both_packages(kw):
    """One JSON text builds the JAX package's decoder and the port's, with
    the same knobs, and they decode alike: bit-flip bitwise given the JAX
    package's tie-break draws, BP-OTS with equal flags and iterations."""
    text = lt.DecoderConfig(**kw).to_json()
    H = lt.parity_check_matrix(120, 6, 3, rng=51)
    ref = lt.DecoderConfig.from_json(text).build(H)
    port = pt.DecoderConfig.from_json(text).build(H, device="cpu")
    assert type(port).__name__ == type(ref).__name__
    assert (port.per, port.max_iters) == (ref.per, ref.max_iters)
    rng = np.random.default_rng(3)
    errs = rng.random((32, H.shape[1])) < 0.02
    syn = ((errs.astype(np.int64) @ H.T) % 2).astype(np.uint8)
    want = ref.batch_decode_detailed(syn, seed=4)
    if kw["kind"] == "bitflip":
        key = jax.random.PRNGKey(4)
        got = port.bitflip(torch.as_tensor(syn), uniforms=lambda it: np.array(
            jax.random.uniform(jax.random.fold_in(key, it), syn.shape[:1] + (H.shape[1],))))
        got = [t.numpy() for t in got]
    else:
        assert (port.T, port.C) == (ref.T, ref.C) == (5, 1.5)
        got = port.batch_decode_detailed(syn, seed=4)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w)


def test_config_validation_matches_reference():
    for kw, match in ((dict(kind="nope"), "unknown decoder kind"),
                      (dict(kind="ensemble"), "at least one member"),
                      (dict(kind="bp", members=(dict(kind="bp"),)), "ensemble-only"),
                      (dict(kind="ensemble", members=(dict(kind="ensemble"),)), "nest"),
                      (dict(kind="detector", inner_kind="spacetime"), "wrapper kind")):
        for mod in (lt, pt):
            with pytest.raises(ValueError, match=match):
                mod.DecoderConfig(**kw)
    A, pr, O = _small_dem(11)
    with pytest.raises(ValueError, match="staged"):
        pt.DecoderConfig(kind="staged").build(A, device="cpu")
    with pytest.raises(ValueError, match="deep_dtype"):
        pt.DecoderConfig(kind="staged", deep_dtype="f16").build((A, pr), device="cpu")
    with pytest.raises(ValueError, match="detector"):
        pt.DecoderConfig(kind="detector").build(A, device="cpu")
    with pytest.raises(ValueError, match=r"\(base, Z\)"):
        pt.DecoderConfig(kind="qc_minsum").build(A, device="cpu")
    dec = pt.DecoderConfig(kind="staged", per=0.003, max_iters=96, gammas=(0.4, [-0.2, 0.6]),
                           stage0_iters=32, relay_legs=1, lam=16, lam3=8).build(
                               (A, pr, O), device="cpu")
    assert dec.K == 2 and dec.lam == 16 and dec.lam3 == 8 and dec.deep_iters == 96
    assert dec.deep_dtype == torch.float32


def test_qc_backend_names():
    base = lt.random_qc_base_matrix(8, 4, 2, 16, rng=0)
    for name, want in (("auto", "cuda"), ("pallas", "cuda"), ("xla", "lifted")):
        dec = pt.DecoderConfig(kind="qc_minsum", backend=name).build((base, 16), device="cpu")
        assert dec.backend == want
    with pytest.raises(ValueError, match="backend"):
        pt.DecoderConfig(kind="qc_minsum", backend="tpu").build((base, 16), device="cpu")


def test_dem_path_builds_the_detector_decoder():
    cfg = pt.DecoderConfig(kind="detector", max_iters=10, inner_kind="minsum",
                           dem_path=str(pathlib.Path(__file__).parent / "fixtures"
                                        / "surface_d3_r3_p005.dem"))
    dec = cfg.build(None, device="cpu")
    assert isinstance(dec, pt.DetectorGraphDecoder) and (dec.D, dec.N) == (24, 201)


@pytest.mark.parametrize("fraction,lo,hi", [(0.85, 256, 8192), (0.45, 32, 16384),
                                            (0.5, 32, 64)])
@pytest.mark.parametrize("hbm_bytes", [4_000_000, 16_000_000_000, 80_000_000_000])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_max_lanes_for_matches_reference(monkeypatch, fraction, lo, hi, hbm_bytes,
                                         dtype_bytes):
    """The reference's model and ceilings, with the port's headroom: the
    port measured its eager decode's peaks on the card and raised the
    constant (utils/hbm.py), the rest of the model is the reference's."""
    A, _, _ = _small_dem(1)
    g = lt.TannerGraph.from_pcm(A)
    gp = pt.TannerGraph.from_arrays(**dataclasses.asdict(g))
    kw = dict(dtype_bytes=dtype_bytes, fraction=fraction, hbm_bytes=hbm_bytes, lo=lo, hi=hi)
    assert (ref_hbm._HEADROOM, hbm._HEADROOM) == (1.25, 3.25)
    monkeypatch.setattr(ref_hbm, "_HEADROOM", hbm._HEADROOM)
    assert hbm.max_lanes_for(gp, **kw) == ref_hbm.max_lanes_for(g, **kw)
    assert hbm.minsum_bytes_per_lane(gp, dtype_bytes) == ref_hbm.minsum_bytes_per_lane(
        g, dtype_bytes)


def test_device_hbm_bytes_on_the_cpu():
    assert hbm.device_hbm_bytes(hbm_bytes=123) == 123
    # half of host RAM, as the reference answers for its CPU device
    assert hbm.device_hbm_bytes("cpu") == ref_hbm.device_hbm_bytes(jax.devices("cpu")[0])
