"""Port parity: the command line (cli.py, ``python -m ldpcdecoders_tpu_torch``).

Each of the six commands runs with ``--device cpu`` on tests/test_cli.py's
small codes, beside the JAX package's CLI on the same arguments:

  * ``sweep``, ``threshold`` and ``sweep --erasure-rates`` sample on the
    host (numpy streams): their JSON counts equal the JAX CLI's;
  * ``logical`` samples on the device (the JAX package's ``jax.random``
    streams cannot be reproduced): the Wilson intervals overlap;
  * ``dem`` writes the JAX CLI's text, byte for byte;
  * ``train`` then ``bench`` with the neural schedule;
  * the flag errors are the reference's.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from ldpcdecoders_tpu import cli as ref_cli
from ldpcdecoders_tpu_torch import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]
THROUGHPUT = ("throughput_syndromes_per_s", "throughput_pairs_per_s", "throughput_shots_per_s",
              "throughput_decodes_per_s", "wall_seconds", "device_sampled")


def run(main, argv, capsys):
    assert main(argv) == 0
    text = capsys.readouterr().out
    return json.loads(text)


def counts(out):
    return {p: {k: v for k, v in s.items() if k not in THROUGHPUT} for p, s in out.items()}


def overlap(a, b):
    return a[0] <= b[1] and b[0] <= a[1]


SWEEP = ["sweep", "--code", "gallager:120,6,3", "--decoder", "bp", "--pers", "0.01,0.03",
         "--trials", "64", "--batch", "32", "--max-iters", "30"]


def test_sweep_counts_equal_the_jax_cli(tmp_path, capsys):
    got = run(cli.main, SWEEP + ["--checkpoint", str(tmp_path / "ck.json")] + CPU, capsys)
    want = run(ref_cli.main, SWEEP + ["--checkpoint", str(tmp_path / "ref.json")], capsys)
    assert set(got) == {"0.01", "0.03"} and got["0.01"]["trials"] == 64
    assert counts(got) == counts(want)
    assert json.load(open(tmp_path / "ck.json"))["points"][0]["trials"] == 64


def test_sweep_profile_writes_a_trace(tmp_path, capsys):
    got = run(cli.main, SWEEP + ["--profile", str(tmp_path / "prof")] + CPU, capsys)
    assert got["0.03"]["trials"] == 64
    trace, counters = sorted(os.listdir(tmp_path / "prof"),
                             key=lambda f: f.endswith(".counters.json"))
    assert trace.endswith(".pt.trace.json") and counters.endswith(".counters.json")
    text = (tmp_path / "prof" / trace).read_text()
    assert "ldpcdecoders_tpu_torch.sweep" in text and '"ldpc.call"' in text
    calls = json.loads((tmp_path / "prof" / counters).read_text())["calls"]
    assert calls and all(c["counters"]["h2d_bytes"] == 32 * 60 for c in calls)


def test_mixed_sweep_counts_equal_the_jax_cli(capsys):
    argv = ["sweep", "--code", "gallager:120,6,3", "--pers", "0.005", "--erasure-rates",
            "0.02,0.1", "--trials", "64", "--batch", "32", "--max-iters", "30"]
    got = run(cli.main, argv + CPU, capsys)
    want = run(ref_cli.main, argv, capsys)
    assert set(got) == {"0.02", "0.1"} and got["0.1"]["trials"] == 64
    assert got["0.1"]["syndrome_mismatch_rate"] == 0.0  # the OSD completes every lane
    assert counts(got) == counts(want)


def test_threshold_equals_the_jax_cli(capsys):
    argv = ["threshold", "--code", "gallager:120,6,3", "--decoder", "bp", "--trials", "64",
            "--batch", "32", "--max-iters", "20", "--target-ler", "0.1", "--max-probes", "3"]
    got = run(cli.main, argv + CPU, capsys)
    want = run(ref_cli.main, argv, capsys)
    for key in ("threshold", "lo", "hi", "target_ler"):
        assert got[key] == want[key], key
    strip = [{k: v for k, v in p.items() if k not in THROUGHPUT} for p in got["probes"]]
    assert strip == [{k: v for k, v in p.items() if k not in THROUGHPUT}
                     for p in want["probes"]]
    assert len(got["probes"]) == 3


@pytest.mark.parametrize("decoder", ["minsum", "layered_minsum", "bposd"])
def test_bench(decoder, capsys):
    out = run(cli.main, ["bench", "--code", "toric:3", "--decoder", decoder, "--batch", "64",
                         "--max-iters", "30", "--per", "0.02"] + CPU, capsys)
    assert out["decoder"] == decoder and out["batch"] == 64 and out["reps"] == 5
    assert out["syndromes_per_s"] > 0
    assert out["time_min_ms"] <= out["time_median_ms"] <= out["time_max_ms"]
    assert out["spread_pct"] >= 0
    assert 0 <= out["converged_fraction"] <= 1 and out["mean_iters"] > 0


def test_bench_qc_minsum(capsys):
    out = run(cli.main, ["bench", "--code", "qc:6,3,2,16", "--decoder", "qc_minsum",
                         "--schedule", "layered", "--batch", "32", "--max-iters", "12",
                         "--per", "0.03", "--reps", "2"] + CPU, capsys)
    assert out["decoder"] == "qc_minsum" and out["reps"] == 2 and out["syndromes_per_s"] > 0


def test_train_then_bench_neural(tmp_path, capsys):
    sched = str(tmp_path / "sched.npz")
    out = run(cli.main, ["train", "--code", "gallager:120,6,3", "--max-iters", "6", "--per",
                         "0.04", "--steps", "12", "--train-batch", "32", "--out", sched] + CPU,
              capsys)
    assert out["schedule"] == sched and out["steps"] == 12
    assert out["loss_last"] < out["loss_first"]
    bench = run(cli.main, ["bench", "--code", "gallager:120,6,3", "--decoder", "neural_minsum",
                           "--schedule-file", sched, "--max-iters", "6", "--batch", "32",
                           "--reps", "2"] + CPU, capsys)
    assert bench["decoder"] == "neural_minsum" and bench["syndromes_per_s"] > 0


@pytest.mark.parametrize("rounds", [1, 2])
def test_logical_intervals_overlap_the_jax_cli(rounds, capsys):
    argv = ["logical", "--code", "toric:3", "--pers", "0.05", "--trials", "512", "--batch",
            "128", "--max-iters", "30", "--rounds", str(rounds)]
    got = run(cli.main, argv + CPU, capsys)["0.05"]
    want = run(ref_cli.main, argv, capsys)["0.05"]
    assert got.keys() == want.keys()
    assert got["trials"] == want["trials"] == 512
    for key in ("z_logical_ci95", "x_logical_ci95", "any_logical_ci95"):
        assert overlap(got[key], want[key]), key


def test_dem_text_is_the_jax_clis_and_decodes(tmp_path, capsys):
    argv = ["dem", "--code", "surface:3", "--rounds", "2", "--p", "0.003"]
    got = run(cli.main, argv + ["--out", str(tmp_path / "a.dem")], capsys)
    want = run(ref_cli.main, argv + ["--out", str(tmp_path / "b.dem")], capsys)
    assert (tmp_path / "a.dem").read_bytes() == (tmp_path / "b.dem").read_bytes()
    assert {k: v for k, v in got.items() if k != "out"} == \
        {k: v for k, v in want.items() if k != "out"}
    argv = ["logical", "--dem", str(tmp_path / "a.dem"), "--trials", "1024", "--batch", "512",
            "--max-iters", "30", "--rounds", "2"]
    got = run(cli.main, argv + CPU, capsys)
    want = run(ref_cli.main, argv, capsys)
    assert got["shots"] == want["shots"] == 1024
    assert overlap(got["logical_ci95"], want["logical_ci95"])


@pytest.mark.parametrize("argv, match", [
    (["bench", "--code", "toric:3", "--decoder", "nope"], "unknown decoder 'nope'"),
    (["bench", "--code", "mystery:3"], "unknown code spec 'mystery:3'"),
    (["bench", "--code", "toric:3", "--decoder", "qc_minsum"], "quasi-cyclic code spec"),
    (["sweep", "--code", "gallager:120,6,3", "--pers", "0.005,0.01", "--erasure-rates", "0.1",
      "--trials", "8"], "one --pers"),
    (["sweep", "--code", "gallager:120,6,3", "--pers", "0.005", "--erasure-rates", "0.1",
      "--trials", "8", "--decoder", "minsum"], "MixedChannelDecoder"),
    (["logical", "--code", "toric:3", "--pers", "0.01", "--trials", "32",
      "--meas-error-rate", "0.01"], "rounds > 1"),
    (["logical", "--code", "toric:3", "--pers", "0.01", "--trials", "32", "--rounds", "2",
      "--loss-rate", "0.1"], "rounds=1"),
    (["logical", "--code", "gallager:120,6,3", "--pers", "0.01", "--trials", "32"], "CSS pair"),
    (["logical", "--code", "toric:3", "--trials", "32"], "--pers is required"),
])
def test_flag_errors_are_the_references(argv, match):
    for main in (cli.main, ref_cli.main):
        with pytest.raises(SystemExit, match=match):
            main(argv + (CPU if main is cli.main else []))


def test_code_is_required(capsys):
    for main in (cli.main, ref_cli.main):
        with pytest.raises(SystemExit):
            main(["bench"])
        assert "--code is required" in capsys.readouterr().err


def test_python_dash_m_help_without_jax():
    code = (
        "import runpy, sys\n"
        "sys.argv = ['ldpcdecoders_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('ldpcdecoders_tpu_torch', run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'ldpcdecoders_tpu.'))]\n"
        "print('JAX', ','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "{sweep,bench,threshold,train,logical,dem}" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "JAX"
