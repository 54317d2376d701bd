"""Port parity: the layered (serial-C) min-sum decoder.

The same seeded numpy inputs go through ``ldpcdecoders_tpu`` (JAX on the
CPU) and ``ldpcdecoders_tpu_torch`` on the CPU.  Tolerances:

  * ``build_layers`` is numpy carried over: bitwise;
  * against the reference run op by op (``jax.disable_jit()``) every
    output is bitwise, LLRs included: the port rounds each product, as the
    op-by-op reference does;
  * against the jitted reference, XLA on the CPU contracts the damping mix
    ``gam * mu + (1 - gam) * new`` (and ``alpha * excl - beta`` with
    ``beta != 0``) into fused multiply-adds (ROADMAP.md queue 3): the flags
    (``err``, ``converged``, ``iters``) are equal on every lane and the
    LLRs lie within ``FMA_RTOL`` relative of the largest LLR; without
    damping and with ``beta = 0`` (``fma(a, x, -0)`` is the rounded
    product) the jitted reference is bitwise too.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.codes import qc as ref_qc
from ldpcdecoders_tpu.models.layered import build_layers as ref_build_layers
from ldpcdecoders_tpu_torch.models.layered import build_layers

torch.set_num_threads(1)

#: relative LLR tolerance against the jitted (FMA-contracted) reference
FMA_RTOL = 1e-4


def syndromes(H, per, B, seed):
    rng = np.random.default_rng(seed)
    errs = rng.random((B, H.shape[1])) < per
    return ((errs @ H.T) % 2).astype(np.uint8)


def assert_bitwise(got, want):
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    g, w = np.asarray(got[3]["llrs"], np.float32), np.asarray(want[3]["llrs"], np.float32)
    assert np.array_equal(g, w)


@pytest.mark.parametrize("code", ["gallager", "irregular", "qc"])
def test_build_layers_matches_reference(code):
    if code == "gallager":
        H = lt.parity_check_matrix(240, 8, 4, rng=53)
    elif code == "irregular":
        rng = np.random.default_rng(3)
        H = (rng.random((40, 90)) < 0.08).astype(np.uint8)
        H[:, 0] = 1
    else:
        H = ref_qc.qc_lift(ref_qc.random_qc_base_matrix(6, 3, 2, 16, rng=5), 16)
    ref_layers, ref_L = ref_build_layers(lt.TannerGraph.from_pcm(H))
    layers, L = build_layers(pt.TannerGraph.from_pcm(H))
    assert L == ref_L and np.array_equal(layers, ref_layers)


@pytest.mark.parametrize("damping,beta", [(0.0, 0.0), (0.3, 0.0), (0.25, 0.5)])
def test_decoder_matches_reference_op_by_op(damping, beta):
    """Damping, an offset and a per-bit prior: bitwise against the
    reference under ``jax.disable_jit()``."""
    H = lt.parity_check_matrix(96, 6, 3, rng=11)
    per = np.random.default_rng(2).uniform(0.02, 0.08, H.shape[1])
    syns = syndromes(H, 0.06, 8, seed=5)
    port = pt.LayeredMinSumDecoder(H, per, 12, damping=damping, beta=beta, device="cpu")
    ref = lt.LayeredMinSumDecoder(H, per, 12, damping=damping, beta=beta)
    got = port.batch_decode_detailed(syns)
    with jax.disable_jit():
        want = ref.batch_decode_detailed(syns)
    assert_bitwise(got, want)
    assert port.n_layers == ref.n_layers
    c = got[1]
    assert c.any() and not c.all(), "the case needs lanes that fail and that converge"


def test_decoder_matches_jitted_reference():
    """Against the jitted reference: bitwise undamped at beta 0; with the
    damping mix contracted, flags equal and LLRs within FMA_RTOL."""
    H = lt.parity_check_matrix(240, 8, 4, rng=53)
    syns = syndromes(H, 0.05, 48, seed=7)
    for kw in (dict(), dict(damping=0.3)):
        port = pt.LayeredMinSumDecoder(H, 0.05, 20, device="cpu", **kw)
        ref = lt.LayeredMinSumDecoder(H, 0.05, 20, **kw)
        got = port.batch_decode_detailed(syns)
        want = ref.batch_decode_detailed(syns)
        for g, w in zip(got[:3], want[:3]):
            assert np.array_equal(g, np.asarray(w))
        g, w = got[3]["llrs"], np.asarray(want[3]["llrs"])
        if not kw:
            assert np.array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=FMA_RTOL * np.abs(w).max())
    # per-call override and the single decode
    e1, c1 = port.batch_decode(syns, per=0.03)
    e2, c2 = ref.batch_decode(syns, per=0.03)
    assert np.array_equal(c1, np.asarray(c2))
    assert np.array_equal(port.decode(syns[0])[0], port.batch_decode(syns[:1])[0][0])


def test_layered_converges_in_fewer_sweeps_than_flooding():
    """The reference's measured claim, at a small size: alpha 0.8 layered
    needs fewer sweeps than flooding min-sum on the same syndromes."""
    H = lt.parity_check_matrix(240, 8, 4, rng=53)
    syns = syndromes(H, 0.03, 64, seed=9)
    lay = pt.LayeredMinSumDecoder(H, 0.03, 30, device="cpu").batch_decode_detailed(syns)
    flo = pt.MinSumDecoder(H, 0.03, 30, alpha=0.8, device="cpu").batch_decode_detailed(syns)
    assert lay[1].mean() >= flo[1].mean() - 0.02
    both = lay[1] & flo[1]
    assert lay[2][both].mean() < flo[2][both].mean()


def test_validation_and_empty_batch():
    H = lt.parity_check_matrix(96, 6, 3, rng=11)
    with pytest.raises(ValueError, match="damping"):
        pt.LayeredMinSumDecoder(H, 0.05, 5, damping=1.0, device="cpu")
    dec = pt.LayeredMinSumDecoder(H, 0.05, 5, device="cpu")
    e, c = dec.batch_decode(np.zeros((0, H.shape[0]), np.uint8))
    assert e.shape == (0, H.shape[1]) and c.shape == (0,)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lifted_layered_qc_route_matches_reference(dtype):
    """``QCMinSumDecoder(backend="lifted", schedule="layered")`` is the
    layered decoder on the lifted graph, as the reference's XLA layered
    route is: bitwise (alpha 0.8, beta 0, no damping)."""
    import jax.numpy as jnp

    base = ref_qc.random_qc_base_matrix(6, 3, 2, 16, rng=5)
    H = ref_qc.qc_lift(base, 16)
    syns = syndromes(H, 0.05, 16, seed=3)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    port = pt.QCMinSumDecoder(base, 16, 0.05, 10, backend="lifted", schedule="layered",
                              dtype=tdt, device="cpu")
    ref = lt.QCMinSumDecoder(base, 16, 0.05, 10, backend="xla", schedule="layered", dtype=jdt)
    got = port.batch_decode_detailed(syns)
    want = ref.batch_decode_detailed(syns)
    assert_bitwise(got, want)
    assert got[1].mean() > 0.5


def test_config_builds_layered_minsum():
    H = lt.parity_check_matrix(96, 6, 3, rng=11)
    kw = dict(kind="layered_minsum", per=0.05, max_iters=10, damping=0.2)
    dec = pt.DecoderConfig.from_json(lt.DecoderConfig(**kw).to_json()).build(H, device="cpu")
    ref = lt.DecoderConfig(**kw).build(H)
    assert isinstance(dec, pt.LayeredMinSumDecoder)
    syns = syndromes(H, 0.05, 8, seed=1)
    got = dec.batch_decode_detailed(syns)
    with jax.disable_jit():
        want = ref.batch_decode_detailed(syns)
    assert_bitwise(got, want)
