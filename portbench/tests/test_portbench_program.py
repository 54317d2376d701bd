"""The readers of the program's own spans and counters: a traced CPU run of
the harness reports each of them, and each reads nothing where the program
keeps no record of the traced calls."""

import json
import sys
import types

import pytest
from conftest import write_tiny

from portbench import harness, program, spec

NEW = {"copy_share.dem": ("%", "program_span"), "deep_share.dem": ("%", "program_span"),
       "osd_ms_per_lane.dem": ("ms", "program_span"),
       "minsum_useful_share.dem": ("%", "program_counter"),
       "host_reads_per_call.dem": ("reads", "program_counter")}


@pytest.fixture(scope="module")
def program_bench(tmp_path_factory):
    root = tmp_path_factory.mktemp("program")
    bench = write_tiny(root)
    doc = json.loads((root / "BENCHMARK.json").read_text())
    for name, (unit, source) in NEW.items():
        doc["per_layer"].append({"name": name, "unit": unit, "better": "lower", "source": source,
                                 "layer": "tests", "moves": "shots_per_s",
                                 "workloads": ["tiny.dem"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return bench


def test_traced_run_reports_the_program_metrics(program_bench, capsys):
    rc = harness.main(["--workload", "tiny.dem", "--seed", "4294967311", "--seconds", "0.3",
                       "--trace", "1"], allow_cpu=True, bench_dir=program_bench)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == set(NEW) | {"osd_host_share.dem"}
    assert 0 < got["copy_share.dem"] < 100 and 0 < got["deep_share.dem"] < 100
    assert 0 < got["minsum_useful_share.dem"] <= 100
    assert got["osd_ms_per_lane.dem"] > 0
    # per call: stage 0's checks and reads, the deep checks and reads, the
    # OSD inputs, and the contract's three outputs
    assert got["host_reads_per_call.dem"] >= 3 + 4 + 2


def test_an_untraced_run_reports_none_of_them(program_bench, capsys):
    rc = harness.main(["--workload", "tiny.dem", "--seed", "7", "--seconds", "0.3"],
                      allow_cpu=True, bench_dir=program_bench)
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and not set(res["metrics"]) & set(NEW)


def span(name, start, end):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end)


def fake_record(calls):
    return types.SimpleNamespace(calls=[types.SimpleNamespace(spans=s, counters=c)
                                        for s, c in calls])


CTX = {"trace": {"window_s": 2.0, "calls": 2, "lane_iters": 600}}
RECORD = fake_record([
    ([span("ldpc.call", 0, 900_000_000), span("ldpc.to_device", 0, 10_000_000),
      span("ldpc.staged.deep", 100_000_000, 400_000_000),
      span("ldpc.staged.relay", 300_000_000, 450_000_000),
      span("ldpc.staged.osd", 500_000_000, 800_000_000),
      span("ldpc.to_host", 850_000_000, 900_000_000)],
     {"host_reads": 20, "osd_lanes": 10, "minsum_lane_iters_launched": 1000}),
    ([span("ldpc.call", 1_000_000_000, 1_500_000_000),
      span("ldpc.to_host", 1_400_000_000, 1_500_000_000)],
     {"host_reads": 4, "minsum_lane_iters_launched": 500}),
])
WANT = {"copy_share.dem": 8.0, "deep_share.dem": 17.5, "osd_ms_per_lane.dem": 30.0,
        "minsum_useful_share.dem": 40.0, "host_reads_per_call.dem": 12.0}


def with_program(monkeypatch, rec):
    mod = types.ModuleType("ldpcdecoders_tpu_torch.utils.profiling")
    if rec is not None:
        mod.profiled = lambda: rec
    monkeypatch.setitem(sys.modules, mod.__name__, mod)


@pytest.mark.parametrize("name", list(NEW))
def test_reader_on_a_synthetic_record(monkeypatch, name):
    with_program(monkeypatch, RECORD)
    assert spec.reader(name)(CTX) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", list(NEW))
@pytest.mark.parametrize("case", ["no_trace", "no_record_kept", "calls_differ", "no_profiled"])
def test_reader_reads_nothing_without_a_record(monkeypatch, name, case):
    ctx = {"trace": None} if case == "no_trace" else CTX
    if case == "no_profiled":  # a program without the record (an older commit)
        with_program(monkeypatch, None)
    else:
        with_program(monkeypatch, {"no_record_kept": None, "no_trace": RECORD,
                                   "calls_differ": fake_record(RECORD_ONE)}[case])
    assert spec.reader(name)(ctx) is None


RECORD_ONE = [([span("ldpc.call", 0, 5)], {"host_reads": 3})]


def test_union_counts_nested_spans_once():
    assert program.seconds(RECORD, "ldpc.staged.deep", "ldpc.staged.relay") == pytest.approx(0.35)
    assert program.totals(RECORD)["host_reads"] == 24
