"""The staged flagship configuration's parts on the CPU at small sizes: the harness
runs ``StagedDemDecoder`` with six members, relay legs and the triple sweep
against ``reference/relay.py`` (correct, and not under a lower-precision
control), the readers of the ``flagship`` metrics read a synthetic record and
nothing without one, and the new reference modules load nothing of the
program.

The tiny cell states a float32 deep ensemble and takes bfloat16 as its
control: on a DEM this small, stage 0 in bfloat16 (the configuration's own
control, which fails on the chip and in tests/test_torch_staged_flagship.py)
moves too few of a window's shots to fail reliably."""

import hashlib
import json
import subprocess
import sys
import types

import numpy as np
import pytest
from conftest import BENCH, write_tiny

from portbench import harness, spec
from portbench.work import minsum_lane_iteration

PAIR = [-0.24, 0.66]
STATED = {"gammas": [0.4] + [PAIR] * 5, "stage0_iters": 16, "deep_iters": 24,
          "relay_iters": 24, "relay_legs": 3, "relay_range": PAIR, "lam": 10, "lam3": 8,
          "check_every": 8, "alpha": 1.0, "dtype": "float32", "deep_dtype": "float32",
          "osd_rank": "abs_llr", "layout": "check", "dmem_seed": 3390, "relay_seed": 57769}
METRICS = {"relay_share.flagship": ("%", "program_span"),
           "ensemble_roofline.flagship": ("%", "device_trace")}
#: the accepted metrics the cell also reports
SHARED = {"device_idle.dem": ("%", "device_trace"), "copy_share.dem": ("%", "program_span"),
          "deep_share.dem": ("%", "program_span"), "osd_host_share.dem": ("%", "program_span"),
          "osd_ms_per_lane.dem": ("ms", "program_span"),
          "host_reads_per_call.dem": ("reads", "program_counter")}


def write_flagship(root):
    """``write_tiny``'s tree under ``root`` with a tiny flagship cell; returns
    its ``portbench`` directory."""
    bench = write_tiny(root)
    conf = json.loads((BENCH / "configs" / "bb144_r6_staged_flagship.json").read_text())
    # the tiny DEM at three times its priors: enough shots reach the deep
    # ensemble, the relay legs and the OSD, and stage 0 in bfloat16 differs
    z = dict(np.load(bench / "data" / "tiny_dem.npz"))
    z["priors"] = 3 * z["priors"]
    path = bench / "data" / "tiny_flagship.npz"
    np.savez(path, **z)
    code = {"kind": "dem", "file": "data/tiny_flagship.npz",
            "sha256": hashlib.sha256(path.read_bytes()).hexdigest()}
    kwargs = {k: STATED[k] for k in ("gammas", "stage0_iters", "deep_iters", "relay_iters",
                                     "relay_legs", "relay_range", "lam", "lam3", "check_every",
                                     "layout", "dtype", "deep_dtype")}
    conf.update(name="tiny_flagship", code=code, stated=STATED,
                control={"deep_dtype": "bfloat16"}, decoder={"class": "StagedDemDecoder",
                         "kwargs": dict(kwargs, min_bucket=4, hbm_bytes=8 << 30)})
    (bench / "configs" / "tiny_flagship.json").write_text(json.dumps(conf))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny_flagship", "source": "tests",
                           "file": "portbench/configs/tiny_flagship.json", "reduced": [],
                           "why": "tests"})
    doc["workloads"].append({"name": "tiny.flagship", "config": "tiny_flagship",
                             "traffic": "tiny_flagship_b64", "chips": 1, "why": "tests"})
    traffic = json.loads((bench / "traffic" / "tiny_dem_b64.json").read_text())
    traffic.update(channel={"priors": {"file": code["file"], "sha256": code["sha256"]}},
                   check_rows_per_call=32)
    (bench / "traffic" / "tiny_flagship_b64.json").write_text(json.dumps(traffic))
    doc["end_to_end"][1]["workloads"].append("tiny.flagship")
    doc["per_layer"] = [m for m in doc["per_layer"] if m["name"] not in SHARED]
    for name, (unit, source) in {**METRICS, **SHARED}.items():
        doc["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                 "source": source, "layer": "tests", "moves": "shots_per_s",
                                 "workloads": ["tiny.flagship"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return bench


@pytest.fixture(scope="module")
def flagship_bench(tmp_path_factory):
    return write_flagship(tmp_path_factory.mktemp("flagship"))


def run(bench, capsys, *args):
    rc = harness.main(["--workload", "tiny.flagship", "--seed", "4294967311", "--seconds", "0.3",
                       *args], allow_cpu=True, bench_dir=bench)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cell_runs_correct_and_traced(flagship_bench, capsys):
    rc, res = run(flagship_bench, capsys)
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"setup_s", "shots_per_s"}
    rc, res = run(flagship_bench, capsys, "--trace", "1")
    assert rc == 0 and res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # the CPU's trace has no device time: the roofline reads nothing
    assert set(got) == {"relay_share.flagship", *SHARED}
    assert 0 < got["relay_share.flagship"] < got["deep_share.dem"] < 100
    assert 0 < got["osd_host_share.dem"] < 100 and got["osd_ms_per_lane.dem"] > 0


def test_control_is_not_correct(flagship_bench, capsys):
    rc, res = run(flagship_bench, capsys, "--control")
    assert rc == 0 and res["correct"] is False and res["checks"]["differ"]["value"] > 0


def span(name, start, end):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end)


RECORD = types.SimpleNamespace(calls=[
    types.SimpleNamespace(spans=[span("ldpc.call", 0, 900_000_000),
                                 span("ldpc.staged.relay", 300_000_000, 400_000_000),
                                 span("ldpc.staged.relay", 400_000_000, 450_000_000)],
                          counters={"stage0_lane_iters": 30_000, "member_lane_iters": 500_000,
                                    "relay_lanes": 40, "relay_lanes_padded": 64}),
    types.SimpleNamespace(spans=[span("ldpc.call", 1_000_000_000, 1_500_000_000),
                                 span("ldpc.staged.relay", 1_100_000_000, 1_200_000_000)],
                          counters={"stage0_lane_iters": 20_000, "member_lane_iters": 300_000,
                                    "relay_lanes": 20, "relay_lanes_padded": 32})])
CTX = {"trace": {"window_s": 2.0, "calls": 2, "busy_in_calls_s": 1.2},
       "config": {"stated": dict(STATED, deep_dtype="bfloat16")},
       "code": {"m": 864, "n": 31648, "edges": 203444}}
WANT = {"relay_share.flagship": 12.5,
        "ensemble_roofline.flagship": 100.0 * (
            50_000 * minsum_lane_iteration(203444, 31648, 864, 4, True)[2]
            + 800_000 * minsum_lane_iteration(203444, 31648, 864, 2, True)[2]) / 1.2}


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


def test_roofline_reads_nothing_from_a_program_without_its_counters(monkeypatch):
    """A program that records calls but not the ensemble's work (an older
    commit) gives no share, not 0."""
    calls = [types.SimpleNamespace(spans=c.spans, counters={"relay_lanes": 1})
             for c in RECORD.calls]
    with_program(monkeypatch, types.SimpleNamespace(calls=calls))
    assert spec.reader("ensemble_roofline.flagship")(CTX) is None
    assert spec.reader("relay_share.flagship")(CTX) == pytest.approx(WANT["relay_share.flagship"])


def test_new_reference_modules_load_nothing_of_the_program():
    code = ("import sys; import portbench.reference.relay, portbench.reference.osd3; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ldpcdecoders_tpu_torch', 'ldpcdecoders_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
