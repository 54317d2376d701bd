"""Port parity: the int8 min-sum decoder and the bucketing wrapper.

The same seeded numpy inputs go through ``ldpcdecoders_tpu`` (JAX on the
CPU, jitted) and ``ldpcdecoders_tpu_torch`` on the CPU.  Int8 min-sum is
integer work end to end: every output (``err``, ``converged``, ``iters``,
the int32 ``llr_q``) is bitwise.  ``per_to_quantized_llr`` is carried numpy:
bitwise.  ``BucketedDecoder`` is bitwise its inner decoder's on the same
lanes, and the reference's bucketed output.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.models.priors import per_to_quantized_llr as ref_q
from ldpcdecoders_tpu_torch.models.priors import per_to_quantized_llr

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def code():
    return lt.parity_check_matrix(240, 8, 4, rng=53)


def syndromes(H, per, B, seed):
    rng = np.random.default_rng(seed)
    errs = rng.random((B, H.shape[1])) < per
    return ((errs @ H.T) % 2).astype(np.uint8)


def assert_all_equal(got, want):
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, np.asarray(w))
    assert got[3].keys() == want[3].keys()
    for k in got[3]:
        assert np.array_equal(got[3][k], np.asarray(want[3][k])), k


@pytest.mark.parametrize("scale", [4.0, 2.5])
@pytest.mark.parametrize("beta_q", [0, 1])
def test_int8_minsum_matches_reference(code, beta_q, scale):
    syns = syndromes(code, 0.04, 64, seed=int(10 * scale) + beta_q)
    port = pt.QuantizedMinSumDecoder(code, 0.04, 25, scale=scale, beta_q=beta_q, device="cpu")
    ref = lt.QuantizedMinSumDecoder(code, 0.04, 25, scale=scale, beta_q=beta_q)
    got = port.batch_decode_detailed(syns)
    assert_all_equal(got, ref.batch_decode_detailed(syns))
    assert got[3]["llr_q"].dtype == np.int32
    assert got[1].any() and not got[1].all(), "the case needs lanes that fail and converge"
    # a per-call prior, the single decode
    assert_all_equal(port.batch_decode_detailed(syns[:8], per=0.02),
                     ref.batch_decode_detailed(syns[:8], per=0.02))
    assert np.array_equal(port.decode(syns[3])[0], port.batch_decode(syns[3:4])[0][0])


def test_per_to_quantized_llr_matches_reference():
    for per in (1e-4, 0.001, 0.01, 0.04, 0.2, 0.5, 0.6, 1e-40):
        for scale in (1.0, 2.5, 4.0, 16.0):
            assert per_to_quantized_llr(per, scale) == ref_q(per, scale)
    with pytest.raises(ValueError, match="scalar per"):
        per_to_quantized_llr(np.full(3, 0.1), 4.0)


def test_int8_minsum_validation_and_config(code):
    dec = pt.QuantizedMinSumDecoder(code, 0.04, 5, device="cpu")
    with pytest.raises(ValueError, match="scalar per"):
        dec.batch_decode(np.zeros((1, code.shape[0]), np.uint8), per=np.full(code.shape[1], 0.1))
    kw = dict(kind="minsum_int8", per=0.04, max_iters=20, scale=2.0, beta_q=0)
    built = pt.DecoderConfig.from_json(lt.DecoderConfig(**kw).to_json()).build(code, device="cpu")
    assert isinstance(built, pt.QuantizedMinSumDecoder) and built.scale == 2.0
    syns = syndromes(code, 0.04, 16, seed=2)
    assert_all_equal(built.batch_decode_detailed(syns),
                     lt.DecoderConfig(**kw).build(code).batch_decode_detailed(syns))


@pytest.mark.parametrize("B", [1, 5, 33, 70])
def test_bucketed_equals_its_inner(code, B):
    """Batches 1, 5, 33 (buckets of 8, 8, 64) and 70, past ``max_bucket``
    (chunks of 32, 32, 6): the inner's outputs on the same lanes, bitwise,
    and the reference's bucketed outputs."""
    syns = syndromes(code, 0.05, B, seed=B)
    inner = pt.MinSumDecoder(code, 0.05, 20, alpha=0.8, device="cpu")
    dec = pt.BucketedDecoder(inner, min_bucket=8, max_bucket=32)
    got = dec.batch_decode_detailed(syns)
    want = inner.batch_decode_detailed(syns)
    assert_all_equal(got, want)
    ref = lt.BucketedDecoder(lt.MinSumDecoder(code, 0.05, 20, alpha=0.8), min_bucket=8,
                             max_bucket=32)
    assert_all_equal(got, ref.batch_decode_detailed(syns))
    assert dec.m == inner.m and dec.n == inner.n and dec.device == inner.device


def test_bucketed_bposd_and_validation(code):
    syns = syndromes(code, 0.06, 37, seed=4)
    inner = pt.BeliefPropagationOSDDecoder(code, 0.06, 10, device="cpu")
    dec = pt.BucketedDecoder(inner, min_bucket=4, max_bucket=16)
    g, c = dec.batch_decode(syns)
    gi, ci = inner.batch_decode(syns)
    assert np.array_equal(g, gi) and np.array_equal(c, ci) and not c.all()
    with pytest.raises(ValueError, match="min_bucket"):
        pt.BucketedDecoder(inner, min_bucket=8, max_bucket=4)
    assert pt.BucketedDecoder(inner, min_bucket=5, max_bucket=17).max_bucket == 32
