"""The windowed configuration's parts on the CPU at small sizes: the port's
``WindowedDemDecoder`` with a flagship-style inner (three members, two with
disordered memory, two relay legs) against ``reference/windowed.py`` on
seeded records, shot for shot; the harness on a tiny windowed cell (correct,
traced, and not correct under a lower-precision control); the
configuration's window sizes against the DEM file; the readers of the
``demwin`` metrics on a synthetic record and on nothing; and the reference
loading nothing of the program.

The tiny cell states a float32 deep ensemble and takes bfloat16 as its
control, as the tiny flagship cell does: on a DEM this small, stage 0 in
bfloat16 (the configuration's own control, run on the chip) moves too few
shots to fail reliably."""

import hashlib
import json
import subprocess
import sys
import types

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from conftest import BENCH, write_tiny

from portbench import harness, inputs, spec
from portbench.reference import windowed
from portbench.work import minsum_lane_iteration

PAIR = [-0.24, 0.66]
WINDOWS = {"detectors_per_round": 12, "window": 3, "commit": 1}
STATED = {**WINDOWS, "gammas": [0.4, PAIR, PAIR], "stage0_iters": 16, "deep_iters": 24,
          "relay_iters": 24, "relay_legs": 2, "relay_range": PAIR, "lam": 10, "lam3": 8,
          "check_every": 8, "alpha": 1.0, "dtype": "float32", "deep_dtype": "bfloat16",
          "osd_rank": "abs_llr", "layout": "check", "dmem_seed": 3390, "relay_seed": 57769}
KWARGS = {**WINDOWS, "decoder": "staged", "max_iters": 24,
          **{k: STATED[k] for k in ("gammas", "stage0_iters", "relay_legs", "lam", "lam3",
                                    "check_every", "layout")},
          "min_bucket": 4, "hbm_bytes": 8 << 30}
METRICS = {"window_glue_share.demwin": ("%", "program_span"),
           "window_roofline.demwin": ("%", "device_trace")}
#: the accepted metrics the cell also reports
SHARED = {"device_idle.dem": ("%", "device_trace"), "copy_share.dem": ("%", "program_span"),
          "deep_share.dem": ("%", "program_span"), "osd_ms_per_lane.dem": ("ms", "program_span"),
          "host_reads_per_call.dem": ("reads", "program_counter"),
          "relay_share.flagship": ("%", "program_span")}


def round_dem(seed=7, R=6, r=12, per_round=40):
    """A DEM of ``R`` rounds of ``r`` detectors: a single-detector mechanism on
    each detector, and ``per_round`` mechanisms a round of 1-3 detectors over
    that round and the next (column weights 1-3, as the reference's slot sums
    take them), priors of four levels, two observables."""
    rng = np.random.default_rng(seed)
    cols = [[d] for d in range(R * r)]
    for t in range(R):
        for _ in range(per_round):
            rounds = min(int(rng.integers(1, 3)), R - t)
            pool = np.arange(t * r, (t + rounds) * r)
            first = int(rng.integers(t * r, (t + 1) * r))
            rest = rng.choice(pool[pool != first], int(rng.integers(0, 3)), replace=False)
            cols.append([first, *rest.tolist()])
    A = np.zeros((R * r, len(cols)), np.uint8)
    for j, rows in enumerate(cols):
        A[rows, j] = 1
    priors = np.array([0.004, 0.01, 0.02, 0.03])[rng.integers(0, 4, len(cols))]
    O = (rng.random((2, len(cols))) < 0.1).astype(np.uint8)
    return sp.csr_matrix(A), priors, O


def records(A, priors, B, seed, scale=3.0):
    x = (np.random.default_rng(seed).random((B, A.shape[1])) < scale * priors).astype(np.uint8)
    return (x @ A.T.toarray() % 2).astype(np.uint8)


@pytest.mark.parametrize("wc", [(3, 1), (4, 2)], ids=["w3c1", "w4c2"])
def test_port_equals_the_reference_shot_for_shot(wc):
    import ldpcdecoders_tpu_torch as pt

    A, priors, O = round_dem()
    win = {"window": wc[0], "commit": wc[1]}
    dec = pt.WindowedDemDecoder(A, priors, observables=O, device="cpu",
                                **dict(KWARGS, **win, deep_dtype=torch.bfloat16))
    det = records(A, priors, 48, 11)
    err, conv, iters, aux, _ = dec.batch_decode_detailed(det)
    ref = windowed.decode_stated(A, priors, dict(STATED, **win), det, "cpu")
    assert np.array_equal(err, ref["err"])
    assert np.array_equal(conv, ref["converged"]) and np.array_equal(iters, ref["iters"])
    assert np.array_equal(aux["window_converged"], ref["window_converged"])
    # the records reach the deep ensemble, the relay legs and the host OSD
    assert (~aux["window_converged"]).any() and (~conv).any()
    assert (iters > len(dec._plan) * STATED["stage0_iters"]).any()


def test_reference_plan_and_windows_are_the_published_construction():
    A, priors, _ = round_dem()
    assert windowed.plan(6, 3, 1) == [(0, 3, False), (1, 3, False), (2, 3, False),
                                      (3, 3, True)]
    assert windowed.plan(12, 8, 4) == [(0, 8, False), (4, 8, True)]
    wins = windowed.windows(A, priors, 12, 3, 1)
    committed = np.concatenate([w["cols"][w["commit"]] for w in wins])
    assert np.array_equal(np.sort(committed), np.arange(A.shape[1]))  # each column once
    A3 = np.zeros((8, 3), np.uint8)
    A3[[0, 2, 4], 0] = 1  # rounds 0-2 at two detectors a round
    A3[1, 1] = A3[3, 2] = 1
    with pytest.raises(ValueError, match="spans"):
        windowed.windows(A3, np.full(3, 0.01), 2, 3, 2)
    with pytest.raises(ValueError, match="commit"):
        windowed.windows(A, priors, 12, 3, 3)


def test_reference_branches_on_a_tied_osd_pick(monkeypatch):
    """A window-0 OSD pick with a tied candidate that commits other columns
    (a committed mechanism swapped for its duplicate): the shot's ``osd``
    lists the pick's whole answer and the branch's, whose later windows see
    the same record."""
    A, priors, _ = round_dem()
    j = 6 * 12  # the first mechanism of round 0 past the single-detector ones
    A2 = sp.hstack([A, A[:, j]]).tocsr()
    priors2 = np.append(priors, priors[j])
    jj = A.shape[1]
    cols0 = windowed.windows(A2, priors2, 12, 3, 1)[0]["cols"]
    real, calls = windowed.relay.decode_stated, []

    def with_a_tie(M, p, inner, syn, device):
        out = real(M, p, inner, syn, device)
        calls.append(M.shape)
        if len(calls) == 1:  # window 0 of the whole batch
            x = out["err"][1].astype(np.uint8)
            alt = x.copy()
            alt[np.searchsorted(cols0, [j, jj])] ^= 1
            out["osd"] = {1: (np.stack([x, alt]), np.array([5.0, 5.0]), np.ones(2, bool))}
        return out

    monkeypatch.setattr(windowed.relay, "decode_stated", with_a_tie)
    ref = windowed.decode_stated(A2, priors2, STATED, records(A2, priors2, 6, 5), "cpu")
    assert set(ref["osd"]) == {1}
    cands, scores, cons = ref["osd"][1]
    branch = ref["err"][1].copy()
    branch[[j, jj]] ^= 1
    assert np.array_equal(cands[0], ref["err"][1]) and np.array_equal(cands[1], branch)
    assert list(scores) == [5.0, 5.0] and cons.all()
    assert len(calls) == 4 + 3  # the batch's four windows, the branch's later three
    assert windowed._tied(cands, np.array([5.0, 5.0 + 1e-3]), cons, 0) == []


def test_configuration_sizes_are_the_dem_files():
    conf = json.loads((BENCH / "configs" / "bb144_r12_window_flagship.json").read_text())
    code = inputs.load_code(conf, BENCH)
    s, st = conf["sizes"], conf["stated"]
    assert (s["detectors"], s["mechanisms"], s["edges"]) == (code.m, code.n, code.edges)
    assert s["detectors_per_round"] == st["detectors_per_round"]
    wins = windowed.windows(code.M, np.zeros(code.n), st["detectors_per_round"], st["window"],
                            st["commit"])
    got = [{"rounds": [w["first_round"], w["first_round"] + w["matrix"].shape[0] // 144],
            "closed": w["closed"], "rows": w["matrix"].shape[0], "cols": w["matrix"].shape[1],
            "edges": int(w["matrix"].nnz), "committed": int(w["commit"].sum())} for w in wins]
    assert got == s["windows"]
    kw = conf["decoder"]["kwargs"]
    assert {k: kw[k] for k in WINDOWS} == {k: st[k] for k in WINDOWS}
    assert kw["max_iters"] == st["deep_iters"] == st["relay_iters"]
    windowed.check_settings(st)


def write_windowed(root):
    """``write_tiny``'s tree under ``root`` with a tiny windowed cell; returns its
    ``portbench`` directory."""
    bench = write_tiny(root)
    A, priors, O = round_dem()
    path = bench / "data" / "tiny_window.npz"
    np.savez(path, data=A.data, indices=A.indices, indptr=A.indptr, shape=np.array(A.shape),
             priors=3 * priors, obs=O)
    code = {"kind": "dem", "file": "data/tiny_window.npz",
            "sha256": hashlib.sha256(path.read_bytes()).hexdigest()}
    conf = json.loads((BENCH / "configs" / "bb144_r12_window_flagship.json").read_text())
    wins = windowed.windows(A, priors, 12, 3, 1)
    conf.update(name="tiny_window", code=code, stated=dict(STATED, deep_dtype="float32"),
                control={"deep_dtype": "bfloat16"},
                sizes={"windows": [{"rows": w["matrix"].shape[0], "cols": w["matrix"].shape[1],
                                    "edges": int(w["matrix"].nnz)} for w in wins]},
                decoder={"class": "WindowedDemDecoder",
                         "kwargs": dict(KWARGS, dtype="float32", deep_dtype="float32")})
    (bench / "configs" / "tiny_window.json").write_text(json.dumps(conf))
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny_window", "source": "tests",
                           "file": "portbench/configs/tiny_window.json", "reduced": [],
                           "why": "tests"})
    doc["workloads"].append({"name": "tiny.window", "config": "tiny_window",
                             "traffic": "tiny_window_b64", "chips": 1, "why": "tests"})
    traffic = json.loads((bench / "traffic" / "tiny_dem_b64.json").read_text())
    traffic.update(channel={"priors": {"file": code["file"], "sha256": code["sha256"]}},
                   check_rows_per_call=32)
    (bench / "traffic" / "tiny_window_b64.json").write_text(json.dumps(traffic))
    doc["end_to_end"][1]["workloads"].append("tiny.window")
    doc["per_layer"] = [m for m in doc["per_layer"] if m["name"] not in SHARED]
    for name, (unit, source) in {**METRICS, **SHARED}.items():
        doc["per_layer"].append({"name": name, "unit": unit, "better": "lower",
                                 "source": source, "layer": "tests", "moves": "shots_per_s",
                                 "workloads": ["tiny.window"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return bench


@pytest.fixture(scope="module")
def window_bench(tmp_path_factory):
    return write_windowed(tmp_path_factory.mktemp("windowed"))


def run(bench, capsys, *args):
    rc = harness.main(["--workload", "tiny.window", "--seed", "4294967311", "--seconds", "0.3",
                       *args], allow_cpu=True, bench_dir=bench)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cell_runs_correct_and_traced(window_bench, capsys):
    rc, res = run(window_bench, capsys)
    assert rc == 0 and res["correct"] is True, res["checks"]
    assert set(res["metrics"]) == {"setup_s", "shots_per_s"}
    rc, res = run(window_bench, capsys, "--trace", "1")
    assert rc == 0 and res["correct"] is True, res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    # the CPU's trace has no device time: the roofline reads nothing
    assert set(got) == {"window_glue_share.demwin", *SHARED}
    assert 0 < got["window_glue_share.demwin"] < 100
    assert 0 < got["relay_share.flagship"] < got["deep_share.dem"] < 100
    assert got["osd_ms_per_lane.dem"] > 0 and got["host_reads_per_call.dem"] > 0


def test_control_is_not_correct(window_bench, capsys):
    rc, res = run(window_bench, capsys, "--control")
    assert rc == 0 and res["correct"] is False and res["checks"]["differ"]["value"] > 0


def span(name, start, end):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end)


SIZES = {"windows": [{"rows": 1152, "cols": 51170, "edges": 306400},
                     {"rows": 1152, "cols": 39518, "edges": 255805}]}
RECORD = types.SimpleNamespace(calls=[
    types.SimpleNamespace(spans=[span("ldpc.call", 0, 900_000_000),
                                 span("ldpc.window.commit", 300_000_000, 400_000_000),
                                 span("ldpc.window.commit", 800_000_000, 850_000_000)],
                          counters={"stage0_lane_iters.w0": 30_000, "stage0_lane_iters.w1": 20_000,
                                    "member_lane_iters.w0": 500_000,
                                    "member_lane_iters.w1": 100_000}),
    types.SimpleNamespace(spans=[span("ldpc.call", 1_000_000_000, 1_500_000_000),
                                 span("ldpc.window.commit", 1_100_000_000, 1_200_000_000)],
                          counters={"stage0_lane_iters.w0": 10_000, "stage0_lane_iters.w1": 5_000,
                                    "member_lane_iters.w1": 40_000})])
CTX = {"trace": {"window_s": 2.0, "calls": 2, "busy_in_calls_s": 1.2},
       "config": {"stated": dict(STATED, deep_dtype="bfloat16"), "sizes": SIZES}}


def _least(k, nbytes):
    w = SIZES["windows"][k]
    return minsum_lane_iteration(w["edges"], w["cols"], w["rows"], nbytes, True)[2]


WANT = {"window_glue_share.demwin": 12.5,
        "window_roofline.demwin": 100.0 * (40_000 * _least(0, 4) + 25_000 * _least(1, 4)
                                           + 500_000 * _least(0, 2) + 140_000 * _least(1, 2))
        / 1.2}


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
@pytest.mark.parametrize("case", ["no_trace", "no_profiled", "calls_differ", "no_windows"])
def test_reader_reads_nothing_without_a_record(monkeypatch, name, case):
    ctx = {"trace": None} if case == "no_trace" else CTX
    if case == "calls_differ":
        ctx = dict(CTX, trace=dict(CTX["trace"], calls=3))
    rec = RECORD
    if case == "no_windows":  # a program that records calls but no window (the parent)
        rec = types.SimpleNamespace(calls=[
            types.SimpleNamespace(spans=c.spans[:1], counters={"stage0_lane_iters": 1})
            for c in RECORD.calls])
    with_program(monkeypatch, None if case == "no_profiled" else rec)
    assert spec.reader(name)(ctx) is None


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.windowed; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ldpcdecoders_tpu_torch', 'ldpcdecoders_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"
