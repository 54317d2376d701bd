"""The harness end to end on the CPU at small sizes: the result line, cells
found by name, the control and the faults it must catch, and the modules a
run may not load."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
from conftest import BENCH, write_tiny

from portbench import harness, spec

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(bench, capsys, *args, **kw):
    rc = harness.main(["--seed", "4294967311", "--seconds", "0.3", *args], allow_cpu=True,
                      bench_dir=bench, **kw)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.mark.parametrize("workload", ["tiny.dem", "tiny.bsc"])
def test_result_line(tiny_bench, capsys, workload):
    rc, res = run(tiny_bench, capsys, "--workload", workload)
    assert rc == 0
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    cell = spec.resolve(workload, tiny_bench)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


def test_traced_result(tiny_bench, capsys):
    rc, res = run(tiny_bench, capsys, "--workload", "tiny.dem", "--trace", "1")
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"osd_host_share.dem"}
    assert 0 < res["metrics"]["osd_host_share.dem"]["value"] < 100
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_new_traffic_is_found_by_name(tmp_path, capsys):
    bench = write_tiny(tmp_path)
    traffic = json.loads((bench / "traffic" / "tiny_bsc_b128.json").read_text())
    traffic.update(batch=48, channel={"per": 0.05})
    (bench / "traffic" / "tiny_bsc_p005_b48.json").write_text(json.dumps(traffic))
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tiny.bsc_p005", "config": "tiny_gallager",
                             "traffic": "tiny_bsc_p005_b48", "chips": 1, "why": "added"})
    for m in doc["end_to_end"][2:]:
        m["workloads"].append("tiny.bsc_p005")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    rc, res = run(bench, capsys, "--workload", "tiny.bsc_p005")
    assert rc == 0 and res["correct"] is True
    assert res["attempted"] % 48 == 0
    assert set(res["metrics"]) == {"setup_s", "syndromes_per_s", "decode_ms_p95"}


@pytest.mark.parametrize("workload", ["tiny.dem", "tiny.bsc"])
def test_control_is_not_correct(tiny_bench, capsys, workload):
    rc, res = run(tiny_bench, capsys, "--workload", workload, "--control")
    assert rc == 0 and res["correct"] is False


def unchanged(out, batch):
    err, conv, iters, aux, stats = out
    return np.zeros_like(err), np.zeros_like(conv), np.zeros_like(iters), aux, stats


def half_left_out(out, batch):
    err, conv, iters, aux, stats = (x.copy() if isinstance(x, np.ndarray) else x for x in out)
    h = err.shape[0] // 2
    err[h:], conv[h:], iters[h:] = 0, False, 0
    return err, conv, iters, aux, stats


def answer_altered(out, batch):
    err = out[0].copy()
    lane = int(np.flatnonzero(out[1])[0])  # a converged answer
    err[lane, 0] ^= 1
    return (err, *out[1:])


@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("workload", ["tiny.dem", "tiny.bsc"])
def test_fault_is_not_correct(tiny_bench, capsys, workload, fault):
    rc, res = run(tiny_bench, capsys, "--workload", workload, fault=fault)
    assert rc == 0 and res["correct"] is False


def test_no_card_no_result(tiny_bench, capsys):
    rc = harness.main(["--workload", "tiny.bsc", "--seed", "1", "--seconds", "1"],
                      bench_dir=tiny_bench)
    assert rc != 0 and capsys.readouterr().out == ""


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ldpcdecoders_tpu_torch_x", sys)
    assert "ldpcdecoders_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "ldpcdecoders_tpu.models", sys)
    assert "ldpcdecoders_tpu" in harness.forbidden_loaded()


def test_a_run_loads_no_forbidden_module(tiny_bench):
    code = ("import sys; from portbench import harness; "
            f"rc = harness.main(['--workload', 'tiny.dem', '--seed', '5', '--seconds', '0.3'], "
            f"allow_cpu=True, bench_dir=__import__('pathlib').Path({str(tiny_bench)!r})); "
            "print('LOADED', harness.forbidden_loaded(), rc)")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "LOADED [] 0"


def test_checkout_without_the_program_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("tests"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gallager.p001",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
