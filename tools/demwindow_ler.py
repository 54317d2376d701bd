#!/usr/bin/env python3
"""The windowed decoder's logical error rate through the decoder contract,
against the JAX package's recorded run.

    python3 tools/demwindow_ler.py [--line 2] [--batch 512] [--device cuda]

Reads line ``--line`` of ``benchmarks/results/demwindow_bb144_r5.jsonl`` (the
second: the bb144 R = 12 p = 0.003 DEM by windows of 8 rounds committing 4,
the production inner), draws its shots as ``benchmarks/demwindow_bb144_r5.py``
does (``np.random.default_rng(17)``, mechanisms ``u < priors``, detectors
``A x mod 2``), decodes them with ``WindowedDemDecoder.batch_decode_detailed``
in batches of ``--batch`` and counts a shot as failed where its predicted
observables differ from the drawn ones.  Prints one JSON line (also written to
``chiprun_out/demwindow_ler.json``): the fails, the Wilson 95% interval beside
the recorded run's, whether they overlap, the windows' converged share beside
the recorded one, and the device it ran on; exits 1 where the intervals miss.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--line", type=int, default=2)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()

    import scipy.sparse as sp
    import torch

    import ldpcdecoders_tpu_torch as pt
    from ldpcdecoders_tpu_torch.utils.metrics import wilson_interval

    torch.backends.cuda.matmul.allow_tf32 = False
    results = ROOT / "benchmarks" / "results"
    run = json.loads((results / "demwindow_bb144_r5.jsonl").read_text().splitlines()[a.line - 1])
    cfg, dem = run["config"], run["dem"]
    z = np.load(results / f"bb144_r{dem['rounds']}_p0.003.npz")
    A = sp.csr_matrix((z["data"], z["indices"], z["indptr"]), shape=tuple(z["shape"]))
    pr, O = z["priors"], z["obs"]
    rng = np.random.default_rng(17)
    x = (rng.random((run["shots"], A.shape[1])) < pr[None, :]).astype(np.uint8)
    det = (np.asarray((A @ x.T.astype(np.int32)).T) % 2).astype(np.uint8)
    obs = (x.astype(np.int32) @ O.T.astype(np.int32)) % 2
    gammas = (0.4,) + tuple((-0.24, 0.66) for _ in range(cfg["members"] - 1))
    wd = pt.WindowedDemDecoder(
        A, pr, detectors_per_round=dem["detectors_per_round"], window=cfg["window"],
        commit=cfg["commit"], observables=O, decoder="staged", max_iters=cfg["deep_iters"],
        gammas=gammas, stage0_iters=cfg["stage0_iters"], lam=cfg["lam"], lam3=cfg["lam3"],
        check_every=8, relay_legs=cfg["relay_legs"], deep_dtype=torch.bfloat16,
        layout="check", device=a.device)
    t0 = time.perf_counter()
    fails, wconv, conv = 0, [], []
    for lo in range(0, run["shots"], a.batch):
        err, c, _, aux, _ = wd.batch_decode_detailed(det[lo:lo + a.batch], seed=17)
        pred = (err.astype(np.int32) @ O.T.astype(np.int32)) % 2
        fails += int((pred != obs[lo:lo + a.batch]).any(axis=1).sum())
        wconv.append(aux["window_converged"])
        conv.append(c)
    wall = time.perf_counter() - t0
    wconv = np.concatenate(wconv)
    ci = wilson_interval(fails, run["shots"])
    ref_fails = run["windowed"]["fails"]
    ref_ci = wilson_interval(ref_fails, run["shots"])
    overlap = ci[0] <= ref_ci[1] and ref_ci[0] <= ci[1]
    dev = torch.device(a.device)
    out = {"line": a.line, "window": cfg["window"], "commit": cfg["commit"],
           "shots": run["shots"], "fails": fails, "ler": fails / run["shots"],
           "ci95": list(ci), "recorded_fails": ref_fails, "recorded_ci95": list(ref_ci),
           "overlap": bool(overlap), "window_converged": float(wconv.mean(axis=0).mean()),
           "recorded_window_converged": run["windowed"]["window_converged"],
           "converged_every_window": float(np.concatenate(conv).mean()),
           "wall_s": wall,
           "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    print(json.dumps(out))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "demwindow_ler.json").write_text(json.dumps(out) + "\n")
    return 0 if overlap else 1


if __name__ == "__main__":
    sys.exit(main())
