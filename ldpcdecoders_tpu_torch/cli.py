"""Command line: FER sweeps, throughput benchmarks, thresholds, training,
logical-error sweeps and detector error models.

Counterpart of ``ldpcdecoders_tpu/cli.py``, with the same six commands,
flags and JSON output, and ``--device`` (default: the current CUDA card;
``--device cpu`` decodes on the CPU):

    python -m ldpcdecoders_tpu_torch sweep --code gallager:1000,10,9 \\
        --decoder bposd --pers 0.005,0.01,0.02 --trials 10000 \\
        --batch 4096 --checkpoint sweep.json

    python -m ldpcdecoders_tpu_torch bench --code gallager:1000,10,9 \\
        --decoder minsum --batch 1024

``--profile DIR`` writes a ``torch.profiler`` trace of the command into DIR
(utils/profiling.py), with the command's work as a labelled region and the
decoders' own spans (``ldpc.call`` around each decode call, so around each
timed ``bench`` repetition), and their counters per call beside it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build_code(spec: str):
    """Return ``(H, qc)``: the parity-check matrix and, for quasi-cyclic
    specs, the ``(base, Z)`` structure the QC decoder needs (None otherwise)."""
    import ldpcdecoders_tpu_torch as pt

    kind, _, args = spec.partition(":")
    if kind == "gallager":
        n, wr, wc = (int(x) for x in args.split(","))
        return pt.parity_check_matrix(n, wr, wc, rng=42), None
    if kind == "toric":
        return pt.toric_code_x(int(args)), None
    if kind == "surface":
        return pt.surface_code_x(int(args)), None
    if kind == "repetition":
        return pt.repetition_code(int(args)), None
    if kind == "hamming":
        return pt.hamming_code(int(args)), None
    if kind == "bicycle":
        Hx, _, _ = pt.named_bicycle_code(args)
        return Hx, None  # the X stabilizer block (as toric:d takes toric_code_x)
    if kind == "qc":
        nb, wr, wc, Z = (int(x) for x in args.split(","))
        base = pt.random_qc_base_matrix(nb, wr, wc, Z, rng=42)
        return pt.qc_lift(base, Z), (base, Z)
    if kind == "qcbase":
        base, Z = pt.load_base_matrix(args)
        return pt.qc_lift(base, Z), (base, Z)
    if kind == "pcm":
        return pt.load_pcm(args), None
    if kind == "npz":
        from ldpcdecoders_tpu_torch.utils import load_code_npz

        return load_code_npz(args)[0], None
    raise SystemExit(f"unknown code spec '{spec}'")


def _build_css_pair(spec: str):
    """Return ``(Hx, Hz)`` for CSS code specs (toric:d, surface:d,
    bicycle:name): the pair the logical-error commands need."""
    import ldpcdecoders_tpu_torch as pt

    kind, _, args = spec.partition(":")
    if kind == "toric":
        return pt.toric_code_x(int(args)), pt.toric_code_z(int(args))
    if kind == "surface":
        return pt.surface_code_x(int(args)), pt.surface_code_z(int(args))
    if kind == "bicycle":
        Hx, Hz, _ = pt.named_bicycle_code(args)
        return Hx, Hz
    raise SystemExit(
        f"'{spec}' is not a CSS pair spec (logical sweeps need toric:d, "
        "surface:d, or bicycle:name)"
    )


def _decoder_factory(a, H, qc, device):
    """``per -> decoder`` for ``--decoder`` with the command's knobs."""
    import ldpcdecoders_tpu_torch as pt
    from ldpcdecoders_tpu_torch.config import DecoderConfig

    it = a.max_iters
    table = {
        "bp": lambda per: pt.BeliefPropagationDecoder(H, per, it, device=device),
        "bposd": lambda per: pt.BeliefPropagationOSDDecoder(
            H, per, it, osd_order=a.osd_order, fused=a.fused, osd_scope=a.osd_scope,
            osd_method=a.osd_method, device=device),
        "bitflip": lambda per: pt.BitFlipDecoder(H, per, it, device=device),
        "bpots": lambda per: pt.BPOTSDecoder(H, per, it, T=a.T, C=a.C, device=device),
        "minsum": lambda per: pt.MinSumDecoder(H, per, it, device=device),
        "minsum_int8": lambda per: pt.QuantizedMinSumDecoder(H, per, it, device=device),
        "layered_minsum": lambda per: pt.LayeredMinSumDecoder(H, per, it, device=device),
        "qc_minsum": lambda per: DecoderConfig(
            kind="qc_minsum", per=per, max_iters=it, schedule=a.schedule
        ).build(qc, device=device),
        "neural_minsum": lambda per: DecoderConfig(
            kind="neural_minsum", per=per, max_iters=it, schedule_path=a.schedule_file,
        ).build(H, device=device),
    }
    if a.decoder not in table:
        raise SystemExit(f"unknown decoder '{a.decoder}' (choose from {sorted(table)})")
    if a.decoder == "qc_minsum" and qc is None:
        raise SystemExit(
            "decoder 'qc_minsum' needs a quasi-cyclic code spec "
            "(--code qc:nb,wr,wc,Z or qcbase:path)"
        )
    return table[a.decoder]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ldpcdecoders_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--code", default=None, help="gallager:n,wr,wc | toric:d | surface:d | repetition:n | hamming:r | qc:nb,wr,wc,Z | qcbase:path | bicycle:name | pcm:path | npz:path")
    common.add_argument("--decoder", default="bposd")
    common.add_argument("--max-iters", type=int, default=100)
    common.add_argument("--osd-order", type=int, default=0)
    common.add_argument("--fused", action="store_true",
                        help="bposd: one device program (no host read in a decode)")
    common.add_argument("--osd-scope", default="all", choices=("all", "failed"),
                        help="bposd: run OSD-w on all lanes (reference) or "
                        "failing lanes only (throughput deviation)")
    common.add_argument("--osd-method", default="exhaustive",
                        choices=("exhaustive", "combination_sweep"),
                        help="bposd: reference 2^w sweep, or OSD-CS "
                        "(singles + pairs within --osd-order columns)")
    common.add_argument("--schedule-file", default=None,
                        help="npz schedule from `train` (neural_minsum)")
    common.add_argument("--schedule", default="flooding",
                        choices=("flooding", "layered"),
                        help="qc_minsum: message-passing schedule")
    common.add_argument("--T", type=int, default=9)
    common.add_argument("--C", type=float, default=2.0)
    common.add_argument("--batch", type=int, default=1024)
    common.add_argument("--profile", default=None, help="torch.profiler trace dir")
    common.add_argument("--device", default=None,
                        help="where decoding runs: the current CUDA card by default, "
                        "or e.g. cpu, cuda:1")

    sp = sub.add_parser("sweep", parents=[common], help="FER sweep with checkpoint/resume")
    sp.add_argument("--pers", required=True, help="comma-separated physical error rates")
    sp.add_argument(
        "--erasure-rates", default=None,
        help="comma-separated erasure rates: runs the mixed erasure+flip "
        "sweep (MixedChannelDecoder with OSD completion at --osd-order; "
        "--pers must then be the single flip rate)",
    )
    sp.add_argument("--trials", type=int, default=10000)
    sp.add_argument("--checkpoint", default=None)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--max-seconds", type=float, default=None)

    bp = sub.add_parser("bench", parents=[common], help="throughput benchmark")
    bp.add_argument("--per", type=float, default=0.01)
    bp.add_argument("--reps", type=int, default=5, help="timed repetitions (median reported)")

    th = sub.add_parser(
        "threshold", parents=[common],
        help="bisect the per where LER crosses a target",
    )
    th.add_argument("--target-ler", type=float, default=1e-2)
    th.add_argument("--lo", type=float, default=1e-4)
    th.add_argument("--hi", type=float, default=0.2)
    th.add_argument("--trials", type=int, default=2000, help="trials per probe")
    th.add_argument("--seed", type=int, default=0)
    th.add_argument("--max-probes", type=int, default=12)

    tr = sub.add_parser(
        "train", parents=[common],
        help="train a neural min-sum schedule and save it to npz",
    )
    tr.add_argument("--per", type=float, default=0.01, help="training noise rate")
    tr.add_argument("--per-range", default=None,
                    help="lo,hi — train a rate-robust schedule instead")
    tr.add_argument("--steps", type=int, default=300)
    tr.add_argument("--train-batch", type=int, default=256)
    tr.add_argument("--lr", type=float, default=2e-2)
    tr.add_argument("--param-scope", default="iteration",
                    choices=("iteration", "edge"))
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--out", required=True, help="output npz path")

    lg = sub.add_parser(
        "logical", parents=[common],
        help="degeneracy-aware logical-error sweep of a CSS pair "
             "(toric:d | surface:d | bicycle:name); --rounds > 1 decodes "
             "noisy measurement rounds jointly (phenomenological model)")
    lg.add_argument("--pers", default=None,
                    help="comma-separated physical error rates "
                         "(required unless --dem)")
    lg.add_argument("--trials", type=int, default=4096)
    lg.add_argument("--rounds", type=int, default=1,
                    help="syndrome-measurement rounds per shot (1 = perfect "
                         "measurements, i.e. css_logical_sweep)")
    lg.add_argument("--meas-error-rate", type=float, default=None,
                    help="readout flip rate per bit/round (default: per); "
                         "needs --rounds > 1")
    lg.add_argument("--loss-rate", type=float, default=0.0,
                    help="heralded qubit-loss fraction (rounds=1 only)")
    lg.add_argument("--seed", type=int, default=0)
    lg.add_argument("--dem", default=None, metavar="FILE",
                    help="decode a detector error model file instead of a "
                         "CSS pair: observable-prediction error rate via "
                         "dem_logical_sweep (--trials shots; --rounds is "
                         "metadata for the per-round rate; --pers ignored)")

    dm = sub.add_parser(
        "dem",
        help="build a CSS pair's memory-experiment circuit and write its "
             "exact detector error model (flattened stim format)")
    dm.add_argument("--code", required=True,
                    help="CSS pair spec (toric:d | surface:d | bicycle:name)")
    dm.add_argument("--rounds", type=int, default=3)
    dm.add_argument("--p", type=float, required=True,
                    help="uniform circuit-level depolarizing rate (sets all "
                         "four noise knobs)")
    dm.add_argument("--basis", default="z", choices=("z", "x"))
    dm.add_argument("--out", required=True, help="output .dem path")
    return ap


def _dump(out: dict) -> None:
    print(json.dumps({str(k): v for k, v in out.items()}, indent=2))


def _dem(a) -> int:
    from ldpcdecoders_tpu_torch.codes.circuit import css_memory_circuit, dem_text

    Hx, Hz = _build_css_pair(a.code)
    circ = css_memory_circuit(Hx, Hz, a.rounds, p=a.p, basis=a.basis)
    txt = (f"# {a.code} memory-{a.basis}, {a.rounds} rounds, uniform "
           f"circuit-level depolarizing p={a.p}\n" + dem_text(circ))
    with open(a.out, "w") as f:
        f.write(txt)
    print(json.dumps({
        "out": a.out, "detectors": len(circ.detectors),
        "observables": len(circ.observables),
        "mechanisms": sum(1 for line in txt.splitlines() if line.startswith("error"))}))
    return 0


def _logical(a, device) -> None:
    from ldpcdecoders_tpu_torch.harness import (css_logical_sweep, dem_logical_sweep,
                                                spacetime_logical_sweep)

    if a.dem is not None:
        _dump(dem_logical_sweep(
            a.dem, shots=a.trials, max_iters=a.max_iters, decoder=a.decoder, batch=a.batch,
            seed=a.seed, rounds=a.rounds if a.rounds > 1 else None, osd_order=a.osd_order,
            device=device))
        return
    if a.pers is None:
        raise SystemExit("--pers is required for CSS-pair sweeps")
    Hx, Hz = _build_css_pair(a.code)
    pers = [float(x) for x in a.pers.split(",")]
    knobs = dict(decoder=a.decoder, max_iters=a.max_iters, batch=a.batch, seed=a.seed,
                 osd_order=a.osd_order, device=device)
    if a.rounds > 1:
        if a.loss_rate:
            raise SystemExit(
                "--loss-rate is a rounds=1 feature (heralded loss "
                "under perfect measurements)")
        out = spacetime_logical_sweep(Hx, Hz, pers, rounds=a.rounds,
                                      meas_error_rate=a.meas_error_rate,
                                      trials_per_point=a.trials, **knobs)
    else:
        if a.meas_error_rate is not None:
            raise SystemExit("--meas-error-rate needs --rounds > 1")
        out = css_logical_sweep(Hx, Hz, pers, trials_per_point=a.trials,
                                loss_rate=a.loss_rate, **knobs)
    _dump(out)


def _train(a, H, device) -> None:
    from ldpcdecoders_tpu_torch.models.neural import NeuralMinSumDecoder

    dec = NeuralMinSumDecoder(H, a.per, a.max_iters, param_scope=a.param_scope,
                              device=device)
    kw = {}
    if a.per_range:
        lo, hi = (float(x) for x in a.per_range.split(","))
        kw["per_range"] = (lo, hi)
    t0 = time.perf_counter()
    hist = dec.train(steps=a.steps, batch=a.train_batch, lr=a.lr, seed=a.seed, **kw)
    dec.save_schedule(a.out)
    print(json.dumps({
        "schedule": a.out,
        "param_scope": a.param_scope,
        "steps": a.steps,
        "loss_first": round(hist["losses"][0], 6),
        "loss_last": round(hist["losses"][-1], 6),
        "train_seconds": round(time.perf_counter() - t0, 2),
    }))


def _sweep(a, H, factory, device) -> None:
    from ldpcdecoders_tpu_torch.harness import FERSweep, mixed_fer_sweep

    pers = [float(x) for x in a.pers.split(",")]
    if not a.erasure_rates:
        sweep = FERSweep(H, factory, pers, batch=a.batch, checkpoint_path=a.checkpoint,
                         seed=a.seed)
        _dump(sweep.run(trials_per_point=a.trials, max_seconds=a.max_seconds))
        return
    if len(pers) != 1:
        raise SystemExit(
            "--erasure-rates sweeps the erasure axis; give exactly "
            "one --pers value (the fixed flip rate)"
        )
    # flags this path cannot honour fail rather than being dropped (the
    # decoder is MixedChannelDecoder)
    if a.decoder != "bposd":  # the parser default
        raise SystemExit(
            "--erasure-rates always decodes with MixedChannelDecoder"
            " (min-sum + OSD completion); drop --decoder"
        )
    rates = [float(x) for x in a.erasure_rates.split(",")]
    _dump(mixed_fer_sweep(
        H, pers[0], rates, trials_per_point=a.trials, batch=a.batch, seed=a.seed,
        osd_order=a.osd_order, max_iters=a.max_iters, checkpoint_path=a.checkpoint,
        max_seconds=a.max_seconds, device=device))


def _bench(a, H, factory) -> None:
    """The decode's time: a warm-up call, then ``--reps`` timed calls, each
    ending in a synchronization with the card; the median and the spread."""
    import torch

    dec = factory(a.per)
    cuda = dec.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dec.device)

    rng = np.random.default_rng(0)
    errs = rng.random((a.batch, H.shape[1])) < a.per
    syns = ((errs.astype(np.float32) @ H.T.astype(np.float32)) % 2).astype(np.uint8)
    dec.batch_decode(syns)  # warm-up (and the kernels' first load)
    times = []
    for _ in range(max(1, a.reps)):
        sync()
        t0 = time.perf_counter()
        _, conv, iters, _, stats = dec.batch_decode_detailed(syns)
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    print(json.dumps({
        "decoder": a.decoder,
        "batch": a.batch,
        "reps": len(times),
        "syndromes_per_s": round(a.batch / med, 1),
        "time_median_ms": round(med * 1e3, 3),
        "time_min_ms": round(times[0] * 1e3, 3),
        "time_max_ms": round(times[-1] * 1e3, 3),
        "spread_pct": round(100 * (times[-1] - times[0]) / med, 1),
        "converged_fraction": stats.converged_fraction,
        "mean_iters": round(stats.mean_iters, 2),
    }))


def main(argv=None) -> int:
    ap = _parser()
    a = ap.parse_args(argv)

    if a.cmd != "dem" and getattr(a, "dem", None) is None and a.code is None:
        ap.error("--code is required (unless 'logical --dem FILE')")
    if a.cmd == "dem":
        return _dem(a)

    from ldpcdecoders_tpu_torch.utils.profiling import annotate, trace

    device = a.device  # None: each decoder takes the current CUDA card
    with trace(a.profile), annotate(f"ldpcdecoders_tpu_torch.{a.cmd}"):
        if a.cmd == "logical":
            _logical(a, device)
            return 0
        H, qc = _build_code(a.code)
        if a.cmd == "train":
            _train(a, H, device)
            return 0
        factory = _decoder_factory(a, H, qc, device)
        if a.cmd == "sweep":
            _sweep(a, H, factory, device)
        elif a.cmd == "threshold":
            from ldpcdecoders_tpu_torch.harness import find_threshold

            print(json.dumps(find_threshold(
                H, factory, target_ler=a.target_ler, lo=a.lo, hi=a.hi,
                trials_per_probe=a.trials, batch=a.batch, seed=a.seed,
                max_probes=a.max_probes), indent=2))
        elif a.cmd == "bench":
            _bench(a, H, factory)
    return 0


if __name__ == "__main__":
    sys.exit(main())
