"""The BP+OSD-CS configuration's parts on the CPU at small sizes: the harness
runs ``DetectorGraphDecoder`` against ``reference/bposd.py`` (correct, and
not under the control), and the readers of the ``bposd`` metrics, and of
the ``dem`` metric of the min-sum loop's reads that the cell also reports,
read a synthetic record and nothing without one."""

import json
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
from conftest import BENCH, tiny_dem_arrays, write_tiny

import ldpcdecoders_tpu_torch as pt
from portbench import harness, spec
from portbench.reference import bposd as ref_bposd
from portbench.work_osd import OPS_PER_LANE, PEAK_I32_OPS_PER_S, gf2_elim_lane

STATED = {"max_iters": 40, "inner": "minsum", "damping": 0.4, "alpha": 1.0, "check_every": 1,
          "layout": "var", "dtype": "float32", "osd_method": "combination_sweep",
          "osd_order": 10, "osd_scope": "failed", "osd_rank": "max_exp_llr"}
METRICS = {"osd_device_share.bposd": ("%", "program_span"),
           "gf2_elim_roofline.bposd": ("%", "device_trace"),
           "host_reads_per_call.dem": ("reads", "program_counter")}
#: the cell's other metrics, read from the harness's trace and the program's
#: record in any cell
SHARED = {"minsum_roofline.dem": ("%", "device_trace"),
          "device_idle.dem": ("%", "device_trace"),
          "copy_share.dem": ("%", "program_span"),
          "minsum_useful_share.dem": ("%", "program_counter")}


@pytest.fixture(scope="module")
def bposd_bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("bposd")
    bench = write_tiny(root)
    conf = json.loads((BENCH / "configs" / "bb144_r6_bposd_cs.json").read_text())
    tiny = json.loads((bench / "configs" / "tiny_dem.json").read_text())
    kwargs = dict(conf["decoder"]["kwargs"], max_iters=STATED["max_iters"],
                  osd_order=STATED["osd_order"])
    conf.update(name="tiny_bposd", code=tiny["code"], stated=STATED,
                decoder={"class": "DetectorGraphDecoder", "kwargs": kwargs})
    (bench / "configs" / "tiny_bposd.json").write_text(json.dumps(conf))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny_bposd", "source": "tests",
                           "file": "portbench/configs/tiny_bposd.json", "reduced": [],
                           "why": "tests"})
    doc["workloads"].append({"name": "tiny.bposd", "config": "tiny_bposd",
                             "traffic": "tiny_dem_b64", "chips": 1, "why": "tests"})
    doc["end_to_end"][1]["workloads"].append("tiny.bposd")
    for name, (unit, source) in {**METRICS, **SHARED}.items():
        doc["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                 "source": source, "layer": "tests", "moves": "shots_per_s",
                                 "workloads": ["tiny.bposd"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return bench


def run(bench, capsys, *args):
    rc = harness.main(["--workload", "tiny.bposd", "--seed", "4294967311", "--seconds", "0.3",
                       *args], allow_cpu=True, bench_dir=bench)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cell_runs_correct_and_traced(bposd_bench, capsys):
    rc, res = run(bposd_bench, capsys)
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"setup_s", "shots_per_s"}
    rc, res = run(bposd_bench, capsys, "--trace", "1")
    assert rc == 0 and res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # the CPU's trace lists no elimination kernel and no device time: the
    # roofline reads nothing, the min-sum roofline too
    assert set(got) == {"osd_device_share.bposd", "host_reads_per_call.dem", "device_idle.dem",
                        "copy_share.dem", "minsum_useful_share.dem"}
    assert 0 < got["osd_device_share.bposd"] < 100
    assert got["host_reads_per_call.dem"] >= 5  # checks, the converged flags, the outputs
    assert 0 < got["copy_share.dem"] < 100 and 0 < got["minsum_useful_share.dem"] <= 100


def test_control_is_not_correct(bposd_bench, capsys):
    rc, res = run(bposd_bench, capsys, "--control")
    assert rc == 0 and res["correct"] is False and res["checks"]["differ"]["value"] > 0


def test_reference_matches_program():
    A, O, priors = tiny_dem_arrays()
    rng = np.random.default_rng(9)
    syn = ((rng.random((96, A.shape[1])) < 2 * priors).astype(np.uint8) @ A.T % 2)
    syn = syn.astype(np.uint8)
    dec = pt.DetectorGraphDecoder(sp.csr_matrix(A), priors, STATED["max_iters"],
                                  observables=O, decoder="bposd", inner="minsum",
                                  damping=STATED["damping"], osd_order=STATED["osd_order"],
                                  osd_method="combination_sweep", osd_scope="failed",
                                  device="cpu")
    err, conv, iters, _, _ = dec.batch_decode_detailed(syn)
    ref = ref_bposd.decode_stated(sp.csr_matrix(A), priors, STATED, syn, "cpu")
    assert (~conv).sum() > 5
    assert np.array_equal(err, ref["err"])
    assert np.array_equal(conv, ref["converged"])
    assert np.array_equal(iters, ref["iters"])


def span(name, start, end):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end)


RECORD = types.SimpleNamespace(calls=[
    types.SimpleNamespace(spans=[span("ldpc.call", 0, 900_000_000),
                                 span("ldpc.bposd.osd", 500_000_000, 800_000_000)],
                          counters={"host_reads": 1004, "osd_dev_lanes": 200,
                                    "osd_dev_lanes_padded": 256}),
    types.SimpleNamespace(spans=[span("ldpc.call", 1_000_000_000, 1_500_000_000),
                                 span("ldpc.bposd.osd", 1_100_000_000, 1_200_000_000)],
                          counters={"host_reads": 996, "osd_dev_lanes": 100,
                                    "osd_dev_lanes_padded": 128})])
BREAKDOWN = {"device_ops": [["minsum_check_kernel<float>", 0.5],
                            ["void gf2_cluster_kernel<false>(...)", 0.2],
                            ["Memcpy DtoH (Device -> Pageable)", 0.1]], "idle_gaps": []}
CTX = {"trace": {"window_s": 2.0, "calls": 2, "lane_iters": 600, "breakdown": BREAKDOWN},
       "code": {"m": 864, "n": 31648, "edges": 203444}}
WANT = {"osd_device_share.bposd": 20.0,
        "gf2_elim_roofline.bposd": 100.0 * 300 * gf2_elim_lane(989, 864)[2] / 0.2,
        "host_reads_per_call.dem": 1000.0}


def with_program(monkeypatch, rec):
    mod = types.ModuleType("ldpcdecoders_tpu_torch.utils.profiling")
    if rec is not None:
        mod.profiled = lambda: rec
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


@pytest.mark.parametrize("name", list(METRICS))
def test_reader_on_a_synthetic_record(monkeypatch, name):
    with_program(monkeypatch, RECORD)
    assert spec.reader(name)(CTX) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", list(METRICS))
@pytest.mark.parametrize("case", ["no_trace", "no_profiled", "calls_differ"])
def test_reader_reads_nothing_without_a_record(monkeypatch, name, case):
    ctx = {"trace": None} if case == "no_trace" else CTX
    if case == "calls_differ":
        ctx = dict(CTX, trace=dict(CTX["trace"], calls=3))
    with_program(monkeypatch, None if case == "no_profiled" else RECORD)
    assert spec.reader(name)(ctx) is None


def test_osd_share_reads_nothing_without_its_span(monkeypatch):
    """A program that records calls but no ``ldpc.bposd.osd`` (an older
    commit) gives no share, not 0."""
    calls = [types.SimpleNamespace(spans=c.spans[:1], counters=c.counters) for c in RECORD.calls]
    with_program(monkeypatch, types.SimpleNamespace(calls=calls))
    assert spec.reader("osd_device_share.bposd")(CTX) is None


def test_roofline_reads_nothing_without_an_elimination_kernel(monkeypatch):
    with_program(monkeypatch, RECORD)
    ctx = dict(CTX, trace=dict(CTX["trace"], breakdown={"device_ops": BREAKDOWN["device_ops"][::2],
                                                        "idle_gaps": []}))
    assert spec.reader("gf2_elim_roofline.bposd")(ctx) is None


def test_gf2_lane_bytes_and_operations():
    """The DEM lane's least time is its counted operations', above its
    bytes'; a shape without a count is bounded by its bytes."""
    nbytes, ops, least = gf2_elim_lane(989, 864)
    assert nbytes == 6_846_336 and ops == OPS_PER_LANE[(989, 864)]
    assert least == ops / PEAK_I32_OPS_PER_S > nbytes / 3.35e12
    assert gf2_elim_lane(33, 500) == (4 * (2 * 33 * 500 + 3 * 500), 0,
                                      4 * (2 * 33 * 500 + 3 * 500) / 3.35e12)
