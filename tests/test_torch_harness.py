"""Port parity: the evaluation harness (harness.py).

Host-sampled sweeps draw the JAX package's numpy streams, so with decoders
that are bitwise on these codes (BP, min-sum, BP+OSD on the (120, 6, 3)
Gallager code and the d=3 surface code) the port's counts equal the JAX
package's: ``FERSweep``, ``css_logical_sweep(on_device=False)`` and the
circuit-sampled ``dem_logical_sweep``.  A checkpoint written by either
package resumes in the other.  Device-sampled routes draw from a
``torch.Generator``: they repeat for a seed and resume exactly, but are
compared with the host-sampled ones statistically only.
"""

import json

import numpy as np
import pytest
import torch

import ldpcdecoders_tpu as lt
import ldpcdecoders_tpu_torch as pt
from ldpcdecoders_tpu import harness as ref_h
from ldpcdecoders_tpu_torch import harness as h

torch.set_num_threads(1)

H = lt.parity_check_matrix(120, 6, 3, rng=61)
CPU = dict(device="cpu")
FACTORIES = {
    "bp": (lambda p: lt.BeliefPropagationDecoder(H, p, 40),
           lambda p: pt.BeliefPropagationDecoder(H, p, 40, **CPU)),
    "minsum": (lambda p: lt.MinSumDecoder(H, p, 40),
               lambda p: pt.MinSumDecoder(H, p, 40, **CPU)),
    "bposd0": (lambda p: lt.BeliefPropagationOSDDecoder(H, p, 40),
               lambda p: pt.BeliefPropagationOSDDecoder(H, p, 40, **CPU)),
}


def counts(summary, drop=("throughput_syndromes_per_s", "throughput_pairs_per_s",
                          "throughput_shots_per_s")):
    return {p: {k: v for k, v in s.items() if k not in drop} for p, s in summary.items()}


@pytest.mark.parametrize("kind", sorted(FACTORIES))
def test_fer_sweep_counts_equal_reference(kind):
    ref_f, port_f = FACTORIES[kind]
    kw = dict(batch=64, seed=3)
    want = ref_h.FERSweep(H, ref_f, [0.02, 0.06], multihost=False, **kw).run(
        trials_per_point=128)
    got = h.FERSweep(H, port_f, [0.02, 0.06], **kw).run(trials_per_point=128)
    assert counts(got) == counts(want)
    assert got[0.06]["ler"] > 0  # the points decode something


def test_fer_sweep_sparse_H_and_pipeline_depths():
    import scipy.sparse as sp

    f = FACTORIES["minsum"][1]
    a = h.FERSweep(H, f, [0.04], batch=16, seed=11, pipeline=1).run(trials_per_point=40)
    b = h.FERSweep(sp.csr_matrix(H), f, [0.04], batch=16, seed=11, pipeline=4).run(
        trials_per_point=40)
    assert counts(a) == counts(b) and a[0.04]["trials"] == 40


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A sweep stopped at 64 trials by one package and resumed to 128 by
    the other gives the uninterrupted counts."""
    ref_f, port_f = FACTORIES["bp"]
    ck = str(tmp_path / "ck.json")
    first, second = ((lambda **kw: ref_h.FERSweep(H, ref_f, multihost=False, **kw)),
                     (lambda **kw: h.FERSweep(H, port_f, **kw)))
    if writer == "port":
        first, second = second, first
    kw = dict(pers=[0.02, 0.05], batch=32, seed=9, checkpoint_path=ck)
    first(**kw).run(trials_per_point=64)
    data = json.load(open(ck))
    assert {"seed", "batch", "sample_on_device", "points"} <= set(data)
    assert (h.SAMPLER_KEY in data) == (writer == "port")
    resumed = second(**kw)
    assert resumed.points[0.05].trials == 64
    out = resumed.run(trials_per_point=128)
    full = h.FERSweep(H, port_f, pers=[0.02, 0.05], batch=32, seed=9).run(trials_per_point=128)
    assert counts(out) == counts(full)


def test_mismatch_refusals(tmp_path):
    f = FACTORIES["bp"][1]
    ck = str(tmp_path / "ck.json")
    h.FERSweep(H, f, [0.01], batch=8, checkpoint_path=ck, seed=1).run(trials_per_point=8)
    with pytest.raises(ValueError, match="seed/batch"):
        h.FERSweep(H, f, [0.01], batch=8, checkpoint_path=ck, seed=2)
    with pytest.raises(ValueError, match="seed/batch"):
        h.FERSweep(H, f, [0.01], batch=16, checkpoint_path=ck, seed=1)
    with pytest.raises(ValueError, match="sampling mode"):
        h.FERSweep(H, f, [0.01], batch=8, checkpoint_path=ck, seed=1, sample_on_device=True)
    # a device-sampled checkpoint without the port's sampler (the JAX
    # package's jax.random streams) is refused
    dev_ck = str(tmp_path / "dev.json")
    ref_h.FERSweep(H, FACTORIES["bp"][0], [0.01], batch=8, checkpoint_path=dev_ck, seed=1,
                   multihost=False, sample_on_device=True).run(trials_per_point=8)
    with pytest.raises(ValueError, match="another sampler"):
        h.FERSweep(H, f, [0.01], batch=8, checkpoint_path=dev_ck, seed=1,
                   sample_on_device=True)


def test_device_sampled_sweep_repeats_and_resumes(tmp_path):
    f = FACTORIES["minsum"][1]
    kw = dict(pers=[0.04], batch=32, seed=21, sample_on_device=True)
    a = h.FERSweep(H, f, **kw).run(trials_per_point=96)
    b = h.FERSweep(H, f, **kw).run(trials_per_point=96)
    assert counts(a) == counts(b)
    ck = str(tmp_path / "ck.json")
    h.FERSweep(H, f, checkpoint_path=ck, **kw).run(trials_per_point=32)
    assert json.load(open(ck))[h.SAMPLER_KEY] == h.DEVICE_SAMPLER
    out = h.FERSweep(H, f, checkpoint_path=ck, **kw).run(trials_per_point=96)
    assert counts(out) == counts(a)
    host = h.FERSweep(H, f, [0.04], batch=32, seed=21).run(trials_per_point=96)
    assert abs(host[0.04]["ler"] - a[0.04]["ler"]) < 0.25
    assert a[0.04]["syndrome_match_rate"] <= 1.0 and a[0.04]["mean_iters"] > 0


def test_max_seconds_drains_into_the_checkpoint(tmp_path):
    f = FACTORIES["minsum"][1]
    ck = str(tmp_path / "ck.json")
    kw = dict(pers=[0.02], batch=16, seed=12, pipeline=4)
    h.FERSweep(H, f, checkpoint_path=ck, **kw).run(trials_per_point=64, max_seconds=0.0)
    resumed = h.FERSweep(H, f, checkpoint_path=ck, **kw)
    assert resumed.points[0.02].trials % 16 == 0
    out = resumed.run(trials_per_point=64)
    assert counts(out) == counts(h.FERSweep(H, f, **kw).run(trials_per_point=64))


def test_bitflip_sweep_builds_a_decoder_per_point():
    calls = []

    def factory(p):
        calls.append(p)
        return pt.BitFlipDecoder(H, p, 20, **CPU)

    out = h.FERSweep(H, factory, [0.01, 0.02], batch=16, seed=4).run(trials_per_point=32)
    assert calls == [0.01, 0.02] and out[0.01]["trials"] == 32
    calls.clear()
    h.FERSweep(H, lambda p: calls.append(p) or pt.BeliefPropagationDecoder(H, p, 20, **CPU),
               [0.01, 0.02], batch=16).run(trials_per_point=16)
    assert calls == [0.01]  # one decoder takes every point through per=


def test_find_threshold_brackets_and_repeats():
    Hb = lt.parity_check_matrix(240, 8, 4, rng=17)

    def factory(p):
        return pt.MinSumDecoder(Hb, p, 30, **CPU)

    kw = dict(target_ler=0.5, lo=1e-3, hi=0.2, trials_per_probe=256, batch=64, seed=5,
              max_probes=5, rel_tol=0.2)
    res = h.find_threshold(Hb, factory, **kw)
    assert 1e-3 <= res["lo"] < res["hi"] <= 0.2
    assert res["lo"] <= res["threshold"] <= res["hi"] and len(res["probes"]) >= 3
    strip = lambda r: {**{k: v for k, v in r.items() if k != "probes"},
                       "probes": [counts({0: p})[0] for p in r["probes"]]}
    assert strip(h.find_threshold(Hb, factory, **kw)) == strip(res)
    want = ref_h.find_threshold(Hb, lambda p: lt.MinSumDecoder(Hb, p, 30), **kw)
    assert strip(want) == strip(res)
    with pytest.raises(ValueError):
        h.find_threshold(Hb, factory, lo=0.2, hi=0.1)
    with pytest.raises(ValueError):
        h.find_threshold(Hb, factory, target_ler=0.0)


SURFACE3 = (lt.surface_code_x(3), lt.surface_code_z(3))


@pytest.mark.parametrize("loss_rate", [0.0, 0.1])
def test_css_sweep_host_counts_equal_reference(loss_rate):
    Hx, Hz = SURFACE3
    kw = dict(trials_per_point=256, batch=128, on_device=False, max_iters=30, seed=2,
              loss_rate=loss_rate)
    want = ref_h.css_logical_sweep(Hx, Hz, [0.03, 0.08], **kw)
    got = h.css_logical_sweep(Hx, Hz, [0.03, 0.08], device="cpu", **kw)
    assert counts(got) == counts(want)
    assert got[0.08]["any_logical_rate"] > 0


def test_css_sweep_device_route_repeats():
    Hx, Hz = SURFACE3
    kw = dict(trials_per_point=192, batch=64, max_iters=30, seed=4, device="cpu")
    a = h.css_logical_sweep(Hx, Hz, [0.02, 0.06], **kw)
    b = h.css_logical_sweep(Hx, Hz, [0.02, 0.06], **kw)
    assert counts(a) == counts(b)
    assert a[0.06]["device_sampled"] and "rounds" not in a[0.06]
    assert "throughput_pairs_per_s" in a[0.06]
    host = h.css_logical_sweep(Hx, Hz, [0.06], on_device=False, **kw)
    assert abs(host[0.06]["any_logical_rate"] - a[0.06]["any_logical_rate"]) < 0.15


def test_spacetime_sweep_routes():
    """Two rounds on the d=3 toric code: the host loop's counts equal the
    JAX package's host loop; the device route repeats for a seed."""
    Hx, Hz = lt.toric_code_x(3), lt.toric_code_z(3)
    kw = dict(rounds=2, trials_per_point=96, batch=48, max_iters=20, seed=6, decoder="minsum")
    want = ref_h.spacetime_logical_sweep(Hx, Hz, [0.02], on_device=False, **kw)
    got = h.spacetime_logical_sweep(Hx, Hz, [0.02], on_device=False, device="cpu", **kw)
    assert counts(got) == counts(want) and not got[0.02]["device_sampled"]
    a = h.spacetime_logical_sweep(Hx, Hz, [0.02], device="cpu", **kw)
    b = h.spacetime_logical_sweep(Hx, Hz, [0.02], device="cpu", **kw)
    assert counts(a) == counts(b) and a[0.02]["device_sampled"]
    assert a[0.02]["rounds"] == 2 and a[0.02]["trials"] == 96


SURFACE3_CIRCUIT = lt.css_memory_circuit(*SURFACE3, 3, p=0.005)
SURFACE3_DEM = lt.circuit_dem(SURFACE3_CIRCUIT)


def test_dem_sweep_circuit_sampled_counts_equal_reference():
    kw = dict(shots=1024, batch=256, max_iters=30, seed=5, rounds=3)
    want = ref_h.dem_logical_sweep(SURFACE3_DEM, circuit=SURFACE3_CIRCUIT, on_device=False,
                                   **kw)
    got = h.dem_logical_sweep(SURFACE3_DEM, circuit=pt.css_memory_circuit(
        *SURFACE3, 3, p=0.005), on_device=False, device="cpu", **kw)
    assert counts({0: got}) == counts({0: want}) and got["fails"] > 0
    with pytest.raises(ValueError, match="circuit sampling is host-side"):
        h.dem_logical_sweep(SURFACE3_DEM, circuit=SURFACE3_CIRCUIT, on_device=True,
                            device="cpu")


def test_dem_sweep_device_route_repeats_and_host_route_matches_reference():
    kw = dict(shots=768, batch=256, max_iters=30, seed=8)
    a = h.dem_logical_sweep(SURFACE3_DEM, device="cpu", **kw)
    b = h.dem_logical_sweep(SURFACE3_DEM, device="cpu", **kw)
    assert counts({0: a}) == counts({0: b}) and a["device_sampled"]
    host = h.dem_logical_sweep(SURFACE3_DEM, on_device=False, device="cpu", **kw)
    want = ref_h.dem_logical_sweep(SURFACE3_DEM, on_device=False, **kw)
    assert counts({0: host}) == counts({0: want})
    assert abs(host["logical_rate"] - a["logical_rate"]) < 0.05
    dec = pt.DetectorGraphDecoder(*SURFACE3_DEM[:2], 30, observables=SURFACE3_DEM[2], **CPU)
    assert counts({0: h.dem_logical_sweep(dec, **kw)}) == counts({0: a})
    with pytest.raises(ValueError, match="no logical observables"):
        h.dem_logical_sweep(SURFACE3_DEM[:2] + (np.zeros((0, SURFACE3_DEM[0].shape[1])),),
                            device="cpu", **kw)
