"""Port parity: the reference's public names that the port carries since
the last slices (ROADMAP.md's fault 6), on the CPU.

  * ``save_pcm`` / ``load_pcm``: a file written by either package is read
    back by the other, bitwise;
  * ``ops.syndrome.syndrome_matches`` and the names ``ops`` exports;
  * ``ops.gf2.gf2_osdw``, batched as the port's ``gf2_osd_cs``, bitwise the
    reference's single-lane function over a few lanes;
  * ``TannerGraph.from_pcm(use_native=None / True / False)``: every field
    equal to the reference's on the same route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu import ops as ref_ops
from ldpcdecoders_tpu.ops import gf2 as ref_gf2
from ldpcdecoders_tpu_torch import ops as port_ops
from ldpcdecoders_tpu_torch.ops import gf2 as port_gf2

torch.set_num_threads(1)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_pcm_files_cross_packages(tmp_path, writer):
    H = lt.parity_check_matrix(60, 3, 4, rng=1)
    one_row = np.array([[1, 0, 1, 1]], np.uint8)
    for i, M in enumerate((H, one_row)):
        path = tmp_path / f"H{i}.txt"
        (pt if writer == "port" else lt).save_pcm(M, str(path))
        for reader in (pt.load_pcm, lt.load_pcm, pt.codes.load_pcm):
            got = reader(str(path))
            assert got.dtype == np.int64 and got.ndim == 2
            assert np.array_equal(got, M.astype(np.int64))
    other = tmp_path / "other.txt"
    (lt if writer == "port" else pt).save_pcm(H, str(other))
    assert other.read_bytes() == (tmp_path / "H0.txt").read_bytes()


def test_ops_exports_and_syndrome_matches():
    assert sorted(port_ops.__all__) == sorted(ref_ops.__all__)
    for name in ref_ops.__all__:
        assert callable(getattr(port_ops, name))
    H = lt.parity_check_matrix(60, 3, 4, rng=1)
    rng = np.random.default_rng(3)
    err = (rng.random((8, 60)) < 0.1).astype(np.float32)
    syn = ((err @ H.T) % 2).astype(np.float32)
    syn[::3, 0] = 1 - syn[::3, 0]  # lanes that miss
    Ht = H.T.astype(np.float32)
    want = np.asarray(ref_ops.syndrome_matches(jnp.asarray(err), jnp.asarray(Ht),
                                               jnp.asarray(syn)))
    got = port_ops.syndrome_matches(torch.as_tensor(err), torch.as_tensor(Ht),
                                    torch.as_tensor(syn))
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    assert not want.all() and want.any()


@pytest.mark.parametrize("order", [0, 1, 3])
def test_gf2_osdw_matches_reference(order):
    rng = np.random.default_rng(7 + order)
    B, m, n = 4, 24, 60
    H = (rng.random((B, m, n)) < 0.15).astype(np.uint32)
    Hp = jax.vmap(ref_gf2.pack_bits)(jnp.asarray(H))  # [B, m, W]
    s = (rng.random((B, m)) < 0.5).astype(np.uint32)
    bp = (rng.random((B, n)) < 0.1).astype(np.uint32)
    want = jax.vmap(lambda hp, b, sv: ref_gf2.gf2_osdw(hp, b, sv, order, n))(
        Hp, jnp.asarray(bp), jnp.asarray(s))
    Ht = np.ascontiguousarray(np.transpose(np.asarray(Hp), (0, 2, 1))).view(np.int32)
    got = port_gf2.gf2_osdw(torch.as_tensor(Ht), torch.as_tensor(bp.astype(np.int32)),
                            torch.as_tensor(s.astype(np.int32)), order, n)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))


@pytest.mark.parametrize("use_native", [None, True, False])
@pytest.mark.parametrize("shape", [(60, 3, 4), (1000, 10, 4)], ids=["small", "native_auto"])
def test_from_pcm_routes_give_the_reference_graph(use_native, shape):
    """An 80 x 60 graph (numpy under the default) and a 400 x 1000 one
    (400,000 entries: native under the default), each field equal to the
    reference's graph on the same route; the numpy and native routes agree."""
    n, wr, wc = shape
    H = lt.parity_check_matrix(n, wr, wc, rng=5)
    want = dataclasses.asdict(lt.TannerGraph.from_pcm(H, use_native=use_native))
    got = dataclasses.asdict(pt.TannerGraph.from_pcm(H, use_native=use_native))
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype and np.array_equal(got[key], value), key
        else:
            assert got[key] == value, key
    other = dataclasses.asdict(pt.TannerGraph.from_pcm(H, use_native=not use_native))
    for key, value in got.items():
        assert np.array_equal(other[key], value), key


def test_fault_6_probe_returns_in_the_port(tmp_path):
    """ROADMAP.md's fault-6 probe, every name, ``parallel`` and its 14
    names among them."""
    H = pt.parity_check_matrix(60, 3, 4, rng=1)
    assert pt.TannerGraph.from_pcm(H, use_native=False).n_edges == 240
    pt.save_pcm(H, str(tmp_path / "H.txt"))
    from ldpcdecoders_tpu_torch.ops import gf2, syndrome

    assert callable(syndrome.syndrome_matches) and callable(gf2.gf2_osdw)
    assert pt.parallel.__all__ == lt.parallel.__all__ and len(pt.parallel.__all__) == 14
    assert all(callable(getattr(pt.parallel, name)) for name in pt.parallel.__all__)
