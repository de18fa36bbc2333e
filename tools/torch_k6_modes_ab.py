#!/usr/bin/env python3
"""Kernel K6's project / innovations / latch modes on one CUDA card: a
parent checkout against this one.

Usage, from the root of a checkout, with the parent unpacked into a
directory ``<dir>`` that ``.gitignore`` lists::

    mkdir -p <dir>
    git archive <parent-commit> | tar -x -C <dir>
    python3 tools/torch_k6_modes_ab.py <dir>

Each tree runs in its own process (its own kernel build), in the order
parent, this, this, parent: K6 is held against its plain version on
``chip_smoke.py``'s small products cases (f64 and f32, every mode), and
timed with CUDA events at 512 lanes x 5,000 steps, f32.  Prints each
run's medians, whether the check errors are identical across the trees
(the modes' arithmetic unchanged), and every run's numbers as one JSON
line.  Needs a card; imports no JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import json, sys
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from metran_tpu_torch.kernels import build, lanes_forward, lanes_forward_plain
build.build()
dev = torch.device("cuda")
out = {"errs": {}, "ms": {}}
for dtype in (torch.float64, torch.float32):
    root = "all" if dtype == torch.float64 else "factor"
    for label, kw in (("padded", dict(n_pad=4)),
                      ("unit_root", dict(unit_root=root))):
        rng = np.random.default_rng(cs.SEED + 40)
        *args, _ = cs.lanes_case(rng, 16, 250, dtype, dev, gaps=True, **kw)
        lanes = args[0].shape[1]
        t_last = torch.as_tensor(
            np.r_[0, 250, rng.integers(1, 250, lanes - 2)],
            dtype=torch.int32, device=dev)
        for mode in ("project", "innovations", "latch"):
            tl = t_last if mode == "latch" else None
            got = lanes_forward(*args[:6], mode, args[6], tl)
            want = lanes_forward_plain(*args[:6], mode, args[6], tl)
            out["errs"][f"{label}/{mode}/{dtype}"] = [
                cs.rel_err(g, w) for g, w in zip(got, want)]
rng = np.random.default_rng(cs.SEED + 43)
*args, _ = cs.lanes_case(rng, 512, 5000, torch.float32, dev)
tl = torch.full((512,), 5000, dtype=torch.int32, device=dev)
for mode in ("project", "innovations", "latch"):
    ms, _ = cs.cuda_ms(lambda: lanes_forward(
        *args[:6], mode, args[6], tl if mode == "latch" else None),
        reps=5, warm=1)
    out["ms"][mode] = ms
print("RESULT " + json.dumps(out))
'''


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    here = Path(__file__).resolve().parents[1]
    runs = []
    for name, root in (("parent", parent), ("this", here), ("this", here),
                       ("parent", parent)):
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
        print(name, json.dumps(res["ms"]), flush=True)
    same = all(r["errs"] == runs[0]["errs"] for r in runs)
    print("check errors identical across trees:", same)
    print(json.dumps(runs))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
