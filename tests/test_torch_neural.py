"""Port parity: neural (trainable) min-sum.

The same numpy parameters, syndromes and errors go through the
reference's differentiable forward (``make_soft_minsum_fn``, jitted, with
``jax.value_and_grad`` and optax's sigmoid BCE) and the port's
(:class:`SoftMinSum` with autograd).  Tolerances:

  * LLRs ``[T, B, n]``: within ``LLR_ATOL`` = 1e-4 plus ``LLR_RTOL`` = 1e-5
    relative: the jitted reference may contract ``alpha * excl - beta``
    into a fused multiply-add (ROADMAP.md queue 3), one float32 rounding
    per iteration, carried through T = 5 iterations;
  * the loss within rtol 1e-5, and each gradient within ``GRAD_RTOL`` =
    1e-3 of its largest entry (float32 sums in other orders);
  * one Adam step against ``optax.adam``: within 1e-6 (the same formula);
  * the npz schedules load in both packages, and the trained decoder is
    bitwise the port's ``MinSumDecoder`` with the same arrays (its decode
    is ``MinSumDecode``);
  * training: torch's and JAX's random draws differ, so the check is
    statistical, as tests/test_neural.py's: the loss halves and the
    trained schedule fails less than plain min-sum on a fixed stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu.models.neural import NeuralMinSumDecoder as RefNeural
from ldpcdecoders_tpu.models.neural import make_soft_minsum_fn as ref_soft_fn
from ldpcdecoders_tpu_torch.models.neural import SoftMinSum, soft_minsum_loss

torch.set_num_threads(1)

LLR_ATOL, LLR_RTOL, GRAD_RTOL = 1e-4, 1e-5, 1e-3


@pytest.fixture(scope="module")
def code():
    return lt.parity_check_matrix(120, 6, 3, rng=0)


def case(H, T, B, seed, edge=False):
    rng = np.random.default_rng(seed)
    n = H.shape[1]
    e = (rng.random((B, n)) < 0.06).astype(np.float32)
    syn = ((e @ H.T) % 2).astype(np.float32)
    params = {"alpha": rng.uniform(0.6, 1.1, T).astype(np.float32),
              "beta": rng.uniform(0.0, 0.4, T).astype(np.float32)}
    if edge:
        dv = lt.TannerGraph.from_pcm(H).max_dv
        params["w"] = rng.uniform(0.7, 1.3, (T, dv, n)).astype(np.float32)
    return e, syn, params


@pytest.mark.parametrize("edge", [False, True], ids=["iteration", "edge"])
def test_soft_forward_loss_and_gradients_match_reference(code, edge):
    T, L0 = 5, float(np.log(0.94 / 0.06))
    e, syn, params = case(code, T, 24, seed=3, edge=edge)
    fn = ref_soft_fn(lt.TannerGraph.from_pcm(code), T)

    def ref_loss(p):
        llrs = fn(p, jnp.asarray(syn), L0)
        return jnp.mean(optax.sigmoid_binary_cross_entropy(-llrs, jnp.broadcast_to(e, llrs.shape)))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want_llrs = np.asarray(jax.jit(fn)(jp, jnp.asarray(syn), L0))
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref_loss))(jp)

    soft = SoftMinSum(pt.TannerGraph.from_pcm(code), T, device="cpu")
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    llrs = soft(tp, torch.as_tensor(syn), L0)
    assert llrs.shape == (T, 24, code.shape[1])
    np.testing.assert_allclose(llrs.detach().numpy(), want_llrs, rtol=LLR_RTOL, atol=LLR_ATOL)
    loss = soft_minsum_loss(soft, tp, torch.as_tensor(syn), torch.as_tensor(e), L0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for k in params:
        g, w = tp[k].grad.numpy(), np.asarray(want_grads[k])
        np.testing.assert_allclose(g, w, rtol=0, atol=GRAD_RTOL * np.abs(w).max())


def test_one_adam_step_matches_optax(code):
    T = 4
    e, syn, params = case(code, T, 16, seed=5)
    L0 = float(np.log(0.94 / 0.06))
    grads = {k: np.random.default_rng(1).normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
    tx = optax.adam(2e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    upd, st = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, st, jp)
    want = optax.apply_updates(jp, upd)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    opt = torch.optim.Adam(list(tp.values()), lr=2e-2)
    for k, v in tp.items():
        v.grad = torch.as_tensor(grads[k])
    opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(want[k]), atol=1e-6)
    del e, syn, L0


def test_schedules_cross_packages_and_decode_as_minsum(code, tmp_path):
    T = 6
    _, _, params = case(code, T, 1, seed=7, edge=True)
    ref = RefNeural(code, 0.06, T, param_scope="edge")
    ref.alpha, ref.beta, ref.w = params["alpha"], params["beta"], params["w"]
    ref_path = str(tmp_path / "ref.npz")
    ref.save_schedule(ref_path)
    port = pt.NeuralMinSumDecoder(code, 0.06, T, param_scope="edge", device="cpu")
    port.load_schedule(ref_path)
    assert np.array_equal(port.w, params["w"]) and np.array_equal(port.alpha, params["alpha"])
    port_path = str(tmp_path / "port")
    port.save_schedule(port_path)
    back = RefNeural(code, 0.06, T, param_scope="edge").load_schedule(port_path + ".npz")
    assert np.array_equal(back.beta, params["beta"]) and np.array_equal(back.w, params["w"])
    rng = np.random.default_rng(5)
    syn = (((rng.random((32, code.shape[1])) < 0.06) @ code.T) % 2).astype(np.uint8)
    twin = pt.models.MinSumDecode(port.graph, 0.06, T, device="cpu", alpha=params["alpha"],
                                  beta=params["beta"], edge_weights=params["w"])
    got = port.batch_decode_detailed(syn)
    want = twin(torch.as_tensor(syn))
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, w.numpy())
    # the reference's decode of the same schedule: flags equal (LLRs see the FMA)
    rw = back.batch_decode_detailed(syn)
    for g, w in zip(got[:3], rw[:3]):
        assert np.array_equal(g, np.asarray(w))
    with pytest.raises(ValueError, match="trained for max_iters"):
        pt.NeuralMinSumDecoder(code, 0.06, T + 1, device="cpu").load_schedule(ref_path)
    iter_only = str(tmp_path / "iter.npz")
    RefNeural(code, 0.06, T).save_schedule(iter_only)
    with pytest.raises(ValueError, match="no per-edge weights"):
        pt.NeuralMinSumDecoder(code, 0.06, T, param_scope="edge", device="cpu").load_schedule(
            iter_only)
    cfg = pt.DecoderConfig.from_json(lt.DecoderConfig(
        kind="neural_minsum", per=0.06, max_iters=T, schedule_path=iter_only).to_json())
    built = cfg.build(code, device="cpu")
    assert isinstance(built, pt.NeuralMinSumDecoder) and (built.alpha == 1.0).all()


def test_short_training_lowers_failures(code):
    """As tests/test_neural.py asserts (statistical: torch's draws)."""
    dec = pt.NeuralMinSumDecoder(code, 0.06, 8, device="cpu")
    hist = dec.train(steps=60, batch=128, lr=2e-2, seed=0)
    assert hist["losses"][-1] < hist["losses"][0] * 0.6
    assert not np.allclose(dec.alpha, 1.0)
    assert (dec.alpha >= 1e-2).all() and (dec.beta >= 0).all()
    rng = np.random.default_rng(99)
    e = rng.random((512, code.shape[1])) < 0.06
    syn = ((e @ code.T) % 2).astype(np.uint8)

    def fer(d):
        out, _ = d.batch_decode(syn)
        return 1.0 - (out.astype(bool) == e).all(axis=1).mean()

    assert fer(dec) < fer(pt.MinSumDecoder(code, 0.06, 8, device="cpu")) - 0.05
    frozen = pt.NeuralMinSumDecoder(code, 0.06, 4, learn="alpha", device="cpu")
    frozen.train(steps=3, batch=32, seed=1)
    assert (frozen.beta == 0).all() and not np.allclose(frozen.alpha, 1.0)
    robust = pt.NeuralMinSumDecoder(code, 0.06, 4, device="cpu")
    robust.train(steps=3, batch=32, seed=2, per_range=(0.02, 0.08))
    with pytest.raises(ValueError, match="per_range"):
        robust.train(steps=1, per_range=(0.3, 0.6))
    with pytest.raises(ValueError, match="learn"):
        pt.NeuralMinSumDecoder(code, 0.06, 4, learn="gamma", device="cpu")


def test_module_mode_calls_set_the_mode_and_do_not_train(code):
    """``eval()``, ``train(bool)`` and a parent's mode calls reach
    ``nn.Module.train``: they set the mode, return the module and leave the
    schedule as it was; the decode is the same in either mode."""
    dec = pt.NeuralMinSumDecoder(code, 0.06, 4, device="cpu")
    rng = np.random.default_rng(5)
    e = rng.random((7, code.shape[1])) < 0.06
    syn = ((e @ code.T) % 2).astype(np.uint8)
    want, _ = dec.batch_decode(syn)
    assert dec.eval() is dec and not dec.training
    assert not any(mod.training for mod in dec.modules())
    assert dec.train(True) is dec and all(mod.training for mod in dec.modules())
    assert (dec.alpha == 1.0).all() and (dec.beta == 0.0).all()
    bucketed = pt.BucketedDecoder(dec, min_bucket=4, max_bucket=8)
    assert bucketed.eval() is bucketed and not dec.training
    assert bucketed.train() is bucketed and dec.training
    assert (dec.alpha == 1.0).all() and (dec.beta == 0.0).all()
    got, _ = bucketed.batch_decode(syn)
    assert np.array_equal(got, want)
