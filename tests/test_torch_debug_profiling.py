"""Port parity: utils/debug.py and utils/profiling.py.

``validate_inputs`` and ``check_decode_invariants`` accept and reject
exactly what the JAX package's accept and reject, with every decoder kind of
tests/test_config_debug.py built by both packages' ``DecoderConfig`` on the
same inputs; the port's also take tensors.  ``trace`` writes a
``torch.profiler`` Chrome trace that names the ``annotate``d region, and
``trace(None)`` / ``trace("")`` do nothing.
"""

import json
import os

import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
from ldpcdecoders_tpu.config import DecoderConfig as RefConfig
from ldpcdecoders_tpu.utils import check_decode_invariants as ref_check
from ldpcdecoders_tpu.utils import validate_inputs as ref_validate
from ldpcdecoders_tpu_torch.config import DecoderConfig
from ldpcdecoders_tpu_torch.utils import annotate, check_decode_invariants, trace, validate_inputs

torch.set_num_threads(1)

H = lt.parity_check_matrix(120, 6, 3, rng=3)
KINDS = ("bp", "bposd", "bitflip", "bpots", "minsum", "minsum_int8")


def outcome(fn, *args):
    """The exception type ``fn`` raised, or None."""
    try:
        fn(*args)
    except (ValueError, AssertionError) as e:
        return type(e)
    return None


@pytest.mark.parametrize("syndromes", [
    np.zeros((2, 60), np.uint8),
    np.ones((3, 60), np.int64),
    np.full((2, 60), 3),
    np.zeros((2, 7)),
    np.zeros(60),
    np.array([[0, 1, -1] * 20]),
])
def test_validate_inputs_agrees(syndromes):
    ref = lt.BeliefPropagationDecoder(H, 0.01, 10)
    port = DecoderConfig(kind="bp", per=0.01, max_iters=10).build(H, device="cpu")
    want = outcome(ref_validate, ref, syndromes)
    assert outcome(validate_inputs, port, syndromes) is want
    assert outcome(validate_inputs, port, torch.as_tensor(syndromes)) is want


@pytest.mark.parametrize("kind", KINDS)
def test_decode_invariants_agree(kind):
    rng = np.random.default_rng(4)
    errs = rng.random((16, H.shape[1])) < 0.03
    syns = ((errs @ H.T) % 2).astype(np.uint8)
    ref = RefConfig(kind=kind, per=0.03, max_iters=30).build(H)
    port = DecoderConfig(kind=kind, per=0.03, max_iters=30).build(H, device="cpu")
    e, c, _, aux, _ = port.batch_decode_detailed(syns)
    re, rc, _, raux, _ = ref.batch_decode_detailed(syns)
    check_decode_invariants(port, syns, e, c, aux)
    ref_check(ref, syns, re, rc, raux)
    # and the same outputs as tensors
    check_decode_invariants(port, torch.as_tensor(syns), torch.as_tensor(e), torch.as_tensor(c),
                            {k: torch.as_tensor(v) for k, v in aux.items()})
    # a converged lane whose estimate misses its syndrome, a non-binary
    # estimate, a NaN soft output: each rejected alike
    lane = int(np.flatnonzero(c)[0])
    bad = e.copy()
    bad[lane, 0] ^= 1
    cases = [(bad, c, aux), (np.where(e == 1, 2, e).astype(np.int8), c, aux)]
    soft = next((k for k, v in aux.items() if np.issubdtype(v.dtype, np.floating)), None)
    if soft is not None:
        nan = aux[soft].astype(np.float32).copy()
        nan.flat[0] = np.nan
        cases.append((e, c, {soft: nan}))
    for bad_e, bad_c, bad_aux in cases:
        want = outcome(ref_check, ref, syns, bad_e, bad_c, bad_aux)
        assert outcome(check_decode_invariants, port, syns, bad_e, bad_c, bad_aux) is want


def test_trace_writes_the_annotated_region(tmp_path):
    with trace(str(tmp_path)):
        with annotate("ldpc.test_region"):
            torch.ones(64).cumsum(0)
    name, counters = sorted(os.listdir(tmp_path), key=lambda f: f.endswith(".counters.json"))
    assert name.endswith(".pt.trace.json")
    assert counters == name.replace(".pt.trace.json", ".counters.json")
    events = json.loads((tmp_path / name).read_text())["traceEvents"]
    assert any(ev.get("name") == "ldpc.test_region" for ev in events)
    assert json.loads((tmp_path / counters).read_text()) == {"calls": [], "outside_calls": {}}


@pytest.mark.parametrize("log_dir", [None, ""])
def test_trace_off_is_a_no_op(tmp_path, log_dir):
    before = set(os.listdir(tmp_path))
    with trace(log_dir):
        with annotate("ldpc.untraced"):
            x = torch.ones(4).sum()
    assert float(x) == 4.0 and set(os.listdir(tmp_path)) == before
    assert not torch.autograd.profiler._is_profiler_enabled
