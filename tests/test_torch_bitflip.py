"""Port parity: the bit-flip decoder (models/bitflip.py).

The port's tie-break uniforms come from a ``torch.Generator``, the JAX
package's from ``jax.random.uniform(fold_in(PRNGKey(seed), it), (B, n))``,
which torch cannot reproduce.  Fed the JAX draws (``uniforms=``), the port's
decode is bitwise equal to ``ldpcdecoders_tpu.BitFlipDecoder`` in ``err``,
``converged`` and ``iters``: the votes are integer sums, the tie-break an
argmax over the same float32 draws.  With its own draws the same seed
repeats.  The Julia package's quirks are kept: votes accumulate across
iterations, "all votes negative" stops a lane as converged without a
syndrome match, and the decoder takes no prior.
"""

import jax
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt

torch.set_num_threads(1)


def jax_draws(seed, B, n):
    key = jax.random.PRNGKey(seed)
    return lambda it: np.array(jax.random.uniform(jax.random.fold_in(key, it), (B, n)))


def syndromes(H, B, per, seed):
    errs = np.random.default_rng(seed).random((B, H.shape[1])) < per
    return errs, ((errs.astype(np.int64) @ H.T) % 2).astype(np.uint8)


CASES = [  # (code, per, max_iters, decode seed)
    ((120, 6, 3, 61), 0.01, 100, 0),
    ((120, 6, 3, 61), 0.05, 100, 3),
    ((240, 8, 4, 13), 0.02, 50, 7),
    ((60, 6, 3, 31), 0.15, 30, 11),
]


@pytest.mark.parametrize("code,per,max_iters,seed", CASES)
def test_injected_draws_match_reference_bitwise(code, per, max_iters, seed):
    n, wr, wc, rng = code
    H = lt.parity_check_matrix(n, wr, wc, rng=rng)
    _, syn = syndromes(H, 48, per, seed + 100)
    want = lt.BitFlipDecoder(H, per, max_iters).batch_decode_detailed(syn, seed=seed)
    dec = pt.BitFlipDecoder(H, per, max_iters, device="cpu")
    got = dec.bitflip(torch.as_tensor(syn), uniforms=jax_draws(seed, *syn.shape[:1], H.shape[1]))
    for g, w, what in zip(got, want[:3], ("err", "converged", "iters")):
        assert np.array_equal(g.numpy(), w), what
    if per >= 0.05:  # some lanes must have needed a tie-break and a stop
        assert not want[1].all() or (want[2] > 1).any()


def test_stuck_lanes_report_converged_without_a_match():
    """A lane whose votes all turn negative stops as converged; its
    estimate need not reproduce the syndrome (iterative_bitflip.jl:150-153),
    in both packages alike."""
    H = lt.parity_check_matrix(60, 6, 3, rng=31)
    _, syn = syndromes(H, 64, 0.05, 5)  # 3 of these 64 lanes get stuck
    want = lt.BitFlipDecoder(H, 0.05, 40).batch_decode_detailed(syn, seed=2)
    got = pt.BitFlipDecoder(H, 0.05, 40, device="cpu").bitflip(
        torch.as_tensor(syn), uniforms=jax_draws(2, 64, H.shape[1]))
    err, conv = got[0].numpy(), got[1].numpy()
    assert np.array_equal(err, want[0]) and np.array_equal(conv, want[1])
    unmatched = ((err.astype(np.int64) @ H.T) % 2 != syn).any(axis=1)
    assert (conv & unmatched).any(), "no stuck lane in this batch"
    assert not pt.BitFlipDecoder.converged_implies_syndrome_match


def test_same_seed_repeats_and_seeds_differ():
    H = lt.parity_check_matrix(120, 6, 3, rng=61)
    _, syn = syndromes(H, 64, 0.05, 1)
    dec = pt.BitFlipDecoder(H, 0.05, 100, device="cpu")
    a = dec.batch_decode_detailed(syn, seed=7)
    b = dec.batch_decode_detailed(syn, seed=7)
    c = dec.batch_decode_detailed(syn, seed=8)
    for x, y in zip(a[:3], b[:3]):
        assert np.array_equal(x, y)
    assert not all(np.array_equal(x, y) for x, y in zip(a[:3], c[:3]))


def test_no_prior_overrides():
    H = lt.repetition_code(5)
    dec = pt.BitFlipDecoder(H, 0.05, 10, device="cpu")
    assert not dec.supports_per_override and not dec.supports_vector_prior
    with pytest.raises(ValueError, match="does not support per-call"):
        dec.batch_decode(np.zeros((2, 4), np.uint8), per=0.1)


def test_zero_syndrome_and_single_error():
    H = lt.parity_check_matrix(240, 8, 4, rng=13)
    dec = pt.BitFlipDecoder(H, 0.01, 100, device="cpu")
    guess, ok = dec.decode(np.zeros(H.shape[0], np.uint8))
    assert ok and not guess.any()
    err = np.zeros(H.shape[1], np.uint8)
    err[17] = 1
    guess, ok = dec.decode((H @ err) % 2, seed=0)
    assert ok and np.array_equal(guess.astype(np.uint8), err)


def test_batch_ler_oracle():
    """The Julia package's oracle (test_bf_decoder.jl:35) as a comparison
    of streams: the JAX package's tests/test_bitflip.py holds one decode
    seed under 0.02 at per 0.01; the port's draws are other draws, so the
    mean over four decode seeds (1,200 decodes of the same 300 syndromes)
    must be within 0.005 of the JAX package's mean over the same seeds, and
    below 0.025."""
    H = lt.parity_check_matrix(240, 8, 4, rng=13)
    errs, syn = syndromes(H, 300, 0.01, 2)
    dec = pt.BitFlipDecoder(H, 0.01, 100, device="cpu")
    ref = lt.BitFlipDecoder(H, 0.01, 100)

    def ler(d, seed):
        guesses, _ = d.batch_decode(syn, seed=seed)
        return 1.0 - (guesses.astype(bool) == errs).all(axis=1).mean()

    port = np.mean([ler(dec, s) for s in range(4)])
    want = np.mean([ler(ref, s) for s in range(4)])
    assert abs(port - want) <= 0.005 and port < 0.025, (port, want)


def test_vote_accumulation_on_a_repetition_code():
    """tests/test_bitflip.py:58's case: a single flip on a repetition code,
    where votes accumulate across iterations; both packages agree given the
    same draws, and a converged lane either matches or is stuck."""
    H = lt.repetition_code(10)
    err = np.zeros(10, np.uint8)
    err[4] = 1
    syn = ((H @ err) % 2)[None].astype(np.uint8)
    want = lt.BitFlipDecoder(H, 0.05, 50).batch_decode_detailed(syn, seed=0)
    got = pt.BitFlipDecoder(H, 0.05, 50, device="cpu").bitflip(
        torch.as_tensor(syn), uniforms=jax_draws(0, 1, 10))
    for g, w in zip(got, want[:3]):
        assert np.array_equal(g.numpy(), w)
    guess, ok = pt.BitFlipDecoder(H, 0.05, 50, device="cpu").decode(syn[0], seed=0)
    matched = np.array_equal((H @ guess.astype(int)) % 2, syn[0])
    assert ok and (matched or not pt.BitFlipDecoder.converged_implies_syndrome_match)
