"""Port parity: code construction and Tanner-graph compilation.

``ldpcdecoders_tpu_torch`` carries its own numpy layers; these tests hold
them bitwise against ``ldpcdecoders_tpu`` on the same inputs.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu_torch.models.priors import next_pow2, per_to_ratio, validate_per

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (n, wr, wc, seed): the BP test code, the Pallas OSD test code, and the
# reference benchmark code (whose graph the reference compiles natively)
CODES = [(240, 8, 4, 11), (120, 6, 3, 51), (1000, 10, 9, 42)]


def assert_graphs_equal(g_ref, g_port):
    d_ref, d_port = dataclasses.asdict(g_ref), dataclasses.asdict(g_port)
    assert d_ref.keys() == d_port.keys()
    for k, a in d_ref.items():
        b = d_port[k]
        if a is None or b is None:
            assert a is None and b is None, k
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
            assert np.array_equal(a, b), k
        else:
            assert a == b, k


@pytest.mark.parametrize("n,wr,wc,seed", CODES)
def test_parity_check_matrix_matches_reference(n, wr, wc, seed):
    H_ref = lt.parity_check_matrix(n, wr, wc, rng=seed)
    H = pt.parity_check_matrix(n, wr, wc, rng=seed)
    assert H.dtype == H_ref.dtype
    assert np.array_equal(H, H_ref)
    # a Generator is consumed the same way in both packages
    a = pt.parity_check_matrix(n, wr, wc, rng=np.random.default_rng(seed))
    b = lt.parity_check_matrix(n, wr, wc, rng=np.random.default_rng(seed))
    assert np.array_equal(a, b)


def test_parity_check_matrix_rejects_bad_width():
    with pytest.raises(ValueError, match="divisible"):
        pt.parity_check_matrix(10, 3, 2, rng=0)


@pytest.mark.parametrize("n,wr,wc,seed", CODES)
def test_from_pcm_matches_reference(n, wr, wc, seed):
    H = lt.parity_check_matrix(n, wr, wc, rng=seed)
    g_ref = lt.TannerGraph.from_pcm(H)
    g = pt.TannerGraph.from_pcm(H)
    assert_graphs_equal(g_ref, g)
    for a, b in zip(g_ref.slot_major(), g.slot_major()):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)


def test_from_pcm_irregular_and_padded_degrees():
    rng = np.random.default_rng(3)
    H = (rng.random((37, 61)) < 0.12).astype(np.int64) * 3  # not 0/1 uint8
    H[5] = 0  # an empty check
    H[:, 7] = 0  # an unused variable
    for dm in (1, 8):
        g_ref = lt.TannerGraph.from_pcm(H, degree_multiple=dm, use_native=False)
        g = pt.TannerGraph.from_pcm(H, degree_multiple=dm)
        assert_graphs_equal(g_ref, g)
        for a, b in zip(g_ref.slot_major(), g.slot_major()):
            assert np.array_equal(a, b)


def test_from_pcm_sparse_input_matches_reference():
    import scipy.sparse as sp

    H = lt.parity_check_matrix(120, 6, 3, rng=5)
    coo = sp.coo_matrix(H)
    assert_graphs_equal(lt.TannerGraph.from_pcm(coo), pt.TannerGraph.from_pcm(coo))
    assert_graphs_equal(pt.TannerGraph.from_pcm(coo), pt.TannerGraph.from_pcm(H))


def test_from_edges_matches_reference():
    rng = np.random.default_rng(9)
    m, n = 50, 70
    flat = rng.choice(m * n, size=300, replace=False)
    rows, cols = flat // n, flat % n
    g_ref = lt.TannerGraph.from_edges(rows, cols, m, n)
    g = pt.TannerGraph.from_edges(rows, cols, m, n)
    assert g.H is None
    assert_graphs_equal(g_ref, g)
    with pytest.raises(ValueError, match="dense parity-check"):
        g.require_H()
    with pytest.raises(ValueError, match="duplicate"):
        pt.TannerGraph.from_edges(np.r_[rows, rows[:1]], np.r_[cols, cols[:1]], m, n)
    with pytest.raises(ValueError, match="out of range"):
        pt.TannerGraph.from_edges([m], [0], m, n)


@pytest.mark.parametrize("n,wr,wc,seed", CODES[:2])
def test_from_arrays_round_trips_reference_graph(n, wr, wc, seed):
    g_ref = lt.TannerGraph.from_pcm(lt.parity_check_matrix(n, wr, wc, rng=seed))
    g = pt.TannerGraph.from_arrays(**dataclasses.asdict(g_ref))
    assert isinstance(g, pt.TannerGraph)
    assert_graphs_equal(g_ref, g)
    sparse_ref = lt.TannerGraph.from_edges(*np.nonzero(g_ref.H), g_ref.m, g_ref.n)
    assert_graphs_equal(sparse_ref, pt.TannerGraph.from_arrays(**dataclasses.asdict(sparse_ref)))


def test_priors_match_reference():
    from ldpcdecoders_tpu.models import priors as ref_priors

    for per in (0.01, np.linspace(0.01, 0.2, 5), np.full((2, 5), 0.3)):
        assert np.array_equal(per_to_ratio(per, 5), ref_priors.per_to_ratio(per, 5))
        assert validate_per(per, 5).dtype == np.float64
    with pytest.raises(ValueError, match="per must be"):
        validate_per(np.full(4, 0.1), 5)
    assert [next_pow2(x) for x in (1, 2, 3, 5, 64, 65)] == [1, 2, 4, 8, 64, 128]
    assert all(next_pow2(x) == ref_priors.next_pow2(x) for x in range(1, 70))


def test_port_imports_without_jax():
    """The card's machine has no JAX: importing the port must not pull it in."""
    code = (
        "import sys, ldpcdecoders_tpu_torch\n"
        "import ldpcdecoders_tpu_torch.ops.cuda_gf2, ldpcdecoders_tpu_torch._build\n"
        "import ldpcdecoders_tpu_torch.ops.cuda_qc, ldpcdecoders_tpu_torch.models.spacetime\n"
        "import ldpcdecoders_tpu_torch.codes.bicycle, ldpcdecoders_tpu_torch.utils.metrics\n"
        "import ldpcdecoders_tpu_torch.native, ldpcdecoders_tpu_torch.utils.hbm\n"
        "import ldpcdecoders_tpu_torch.config, ldpcdecoders_tpu_torch.models.staged\n"
        "import ldpcdecoders_tpu_torch.models.detector, ldpcdecoders_tpu_torch.models.ensemble\n"
        "import ldpcdecoders_tpu_torch.harness, ldpcdecoders_tpu_torch.models.bitflip\n"
        "import ldpcdecoders_tpu_torch.models.bpots, ldpcdecoders_tpu_torch.models.css\n"
        "import ldpcdecoders_tpu_torch.codes.css, ldpcdecoders_tpu_torch.codes.circuit\n"
        "import ldpcdecoders_tpu_torch.utils.noise, ldpcdecoders_tpu_torch.utils.io\n"
        "import ldpcdecoders_tpu_torch.models.layered, ldpcdecoders_tpu_torch.models.window\n"
        "import ldpcdecoders_tpu_torch.models.demwindow, ldpcdecoders_tpu_torch.models.neural\n"
        "import ldpcdecoders_tpu_torch.models.peeling, ldpcdecoders_tpu_torch.models.mixed\n"
        "import ldpcdecoders_tpu_torch.models.minsum_q, ldpcdecoders_tpu_torch.models.bucketed\n"
        "assert ldpcdecoders_tpu_torch.native.native_available()\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'ldpcdecoders_tpu.'))"
        " or k == 'ldpcdecoders_tpu']\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"imported: {out.stdout.strip()}"
