#!/usr/bin/env python3
"""The dict service's update dispatch on one CUDA card: a parent checkout
against this one, and the traffic of ``chip_smoke.py``'s arena serving run
against the same fleet's own continuation.

Usage, from the root of a checkout, with the parent unpacked into a
directory ``<dir>`` that ``.gitignore`` lists::

    mkdir -p <dir>
    git archive <parent-commit> | tar -x -C <dir>
    python3 tools/torch_dict_dispatch_ab.py <dir> [pairs]

Each tree runs in its own process (its own kernel build), in ``pairs``
pairs (default 3) that alternate which side runs first: parent, this,
this, parent, parent, this, ...  Each builds the arena serving run's joint
fleet (512 flagship models, f32, ``chip_smoke._fleet_states``' data and
5,000-step history, model 7 poisoned) into a plain ``ModelRegistry
(engine="joint")`` behind ``MetranService(gate=GateSpec("reject",
min_seen=32), detect=DetectSpec(enabled=True))``, alone, and times 8
update dispatches of one request per model (submit to resolved) on two
traffics: ``zero`` — the arena run's rows, whose missing cells arrive as
0.0 readings — and ``nan`` — the same rows with the missing cells NaN
(unobserved); both with NaN cells in round 1 and 30-sd spikes in round 2
(the median of rounds 3-7, which carry neither, is reported apart).
A tree that has the arena also runs ``chip_smoke._arena_serving_run`` on
the ``zero`` traffic, the dict service beside two arena services.  Prints
each run's per-round walls, medians and booked verdict and alarm counts,
then, for each traffic, the pairs the change won (a lower median), both
sides' medians of the runs' medians and the parent's interquartile
distance, and every run as one JSON line.  Needs a card; imports no
JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from metran_tpu_torch.kernels import build
from metran_tpu_torch.ops import dfm_statespace, kalman_filter
from metran_tpu_torch.serve import (DetectSpec, GateSpec, MetranService,
                                    ModelRegistry, PosteriorState)
build.build()
dev = torch.device("cuda")
f32 = np.float32
T, ROUNDS, POISONED, SPIKE = cs.T_STEPS, 8, 7, 30.0
rng = np.random.default_rng(cs.SEED + 130)
y, mask, lds, a_s, a_c = cs.make_workload(rng, cs.FLEET, t=T + 8)
ss = dfm_statespace(a_s.astype(f32), a_c.astype(f32), lds.astype(f32), 1.0,
                    device=dev)
res = kalman_filter(ss, y[:, :T].astype(f32), mask[:, :T], engine="joint",
                    store=False)
covs, means = res.cov_f.cpu().numpy(), res.mean_f.cpu().numpy()
means[POISONED] = np.nan
names = tuple(f"s{j}" for j in range(cs.N_SERIES))
ids = [f"m{i}" for i in range(cs.FLEET)]
states = [PosteriorState(
    model_id=ids[i], version=0, t_seen=T, mean=means[i], cov=covs[i],
    params=np.concatenate([a_s[i], a_c[i]]).astype(f32),
    loadings=lds[i].astype(f32), dt=1.0,
    scaler_mean=np.zeros(cs.N_SERIES, f32),
    scaler_std=np.ones(cs.N_SERIES, f32), names=names, chol=None)
    for i in range(cs.FLEET)]


def traffic(missing):
    rows = y[:, T:] if missing == "zero" else np.where(mask[:, T:], y[:, T:],
                                                       np.nan)
    out = []
    for r in range(ROUNDS):
        obs = np.array(rows[:, r:r + 1], dtype=float)
        if r == 1:
            obs[::9, 0, 2] = np.nan
        if r == 2:
            obs[10:30, 0, 4] += SPIKE
        out.append(obs)
    return out


def snap(svc, name):
    c = getattr(svc, name, None)
    return c.snapshot() if c is not None else None


def run(missing):
    reg = ModelRegistry(engine="joint")
    for st in states:
        reg.put(st, persist=False)
    svc = MetranService(reg, flush_deadline=None, max_batch=1024,
                        persist_updates=False, device="cuda",
                        gate=GateSpec("reject", nsigma=cs.GATE_NSIGMA,
                                      min_seen=32),
                        detect=DetectSpec(enabled=True))
    walls = []
    for obs in traffic(missing):
        t0 = time.perf_counter()
        futs = []
        for i, m in enumerate(ids):
            try:
                futs.append(svc.update_async(m, obs[i]))
            except Exception as exc:  # an open breaker, at submit
                futs.append(exc)
        svc.flush()
        for f in futs:
            if not isinstance(f, Exception):
                f.exception() or f.result()
        walls.append((time.perf_counter() - t0) * 1e3)
    out = {"walls_ms": walls, "median_ms": float(np.median(walls)),
           "median_plain_rounds_ms": float(np.median(walls[3:])),
           "gate_verdicts": snap(svc, "gate_verdicts"),
           "detect_total": snap(svc, "detect_total")}
    svc.close()
    return out


out = {"dict_zero": run("zero"), "dict_nan": run("nan")}
if hasattr(cs, "_arena_serving_run"):
    st, rows = cs._fleet_states("joint", np.random.default_rng(cs.SEED + 130),
                                T, cs.MISSING, poison=POISONED)
    gated = dict(gate=GateSpec("reject", nsigma=cs.GATE_NSIGMA, min_seen=32),
                 detect=DetectSpec(enabled=True))
    assert np.array_equal(rows, y[:, T:])  # the same fleet and rows
    summary, _ = cs._arena_serving_run("joint_gated_detect", "joint", gated,
                                       st, traffic("zero"))
    out["beside_arena"] = {
        k: summary[k] for k in ("update_dispatch_ms",
                                "update_dispatch_ms_by_round", "tallies")}
print("RESULT " + json.dumps(out))
'''


def summary(runs, key):
    """Pairs won by this tree, both sides' medians and the parent's
    interquartile distance for one traffic's median dispatch wall."""
    import numpy as np

    par = [r[key]["median_ms"] for r in runs if r["tree"] == "parent"]
    new = [r[key]["median_ms"] for r in runs if r["tree"] == "this"]
    q1, q3 = np.percentile(par, [25, 75])
    return {"pairs": len(par), "this_won": sum(b < a for a, b in
                                               zip(par, new)),
            "parent_median_ms": float(np.median(par)),
            "this_median_ms": float(np.median(new)),
            "parent_iqr_ms": float(q3 - q1)}


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    pairs = int(sys.argv[2]) if len(sys.argv) == 3 else 3
    here = Path(__file__).resolve().parents[1]
    order = []
    for p in range(pairs):
        pair = (("parent", parent), ("this", here))
        order += pair if p % 2 == 0 else pair[::-1]
    runs = []
    for name, root in order:
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                              capture_output=True, text=True, timeout=900)
        line = [x for x in proc.stdout.splitlines()
                if x.startswith("RESULT ")]
        if not line:
            print(name, "failed:", proc.stdout[-2000:], proc.stderr[-3000:])
            return 1
        res = json.loads(line[0][len("RESULT "):])
        res["tree"] = name
        runs.append(res)
        print(name, json.dumps({k: v for k, v in res.items()
                                if k != "tree"}), flush=True)
    for key in ("dict_zero", "dict_nan"):
        print(key, json.dumps(summary(runs, key)))
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
