#!/usr/bin/env python3
"""Kernel K11 (the batch-layout adjoint) on one CUDA card: a parent
checkout against this one.

Usage, from the root of a checkout, with the parent unpacked into a
directory ``<dir>`` that ``.gitignore`` lists::

    mkdir -p <dir>
    git archive <parent-commit> | tar -x -C <dir>
    python3 tools/torch_k11_ab.py <dir>

Each tree runs in its own process (its own build of K1 and K11 only), in
the order parent, this, this, parent.  Each holds K11 against its plain
version on ``chip_smoke.py``'s small case (8 flagship models, T = 300,
seg 128, K1 boundaries, one model degraded; f64 and f32) and times it
with CUDA events on the flagship inputs (f32, T = 5,000, seg 128, K1
boundaries) at B = 512, 64, 8 and 1 (the first B models of one 512-model
fleet).  This tree also reports its ring depth, shared memory, ring
bytes and blocks per SM, and its times at B = 512, 64 and 1 with the
ring capped at 2 and 4 slots, in each block shape (compact, wide).
Prints each run's numbers and the card's ``nvidia-smi`` name and power
limit as JSON lines.  Needs a card;
imports no JAX.
"""

import json
import subprocess
import sys
from pathlib import Path

CHILD = r'''
import importlib, json, sys
sys.path.insert(0, ".")
import numpy as np, torch
import chip_smoke as cs
from metran_tpu_torch.kernels import build
build.sources = lambda: sorted(build.CSRC / f for f in
                               ("joint_filter.cu", "joint_adjoint.cu"))
build.build()
ja = importlib.import_module("metran_tpu_torch.kernels.joint_adjoint")
dev = torch.device("cuda")
out = {"errs": {}, "ms": {}}
for dtype in (torch.float64, torch.float32):
    rng = np.random.default_rng(cs.SEED + 90)
    ss, y, mask = cs._adjoint_case(rng, 8, cs.ADJ_T, dtype, dev,
                                   degraded=True)
    bm, bc, _ = cs._boundaries("joint", ss, y, mask, cs.ADJ_SEG)
    sb = torch.as_tensor(rng.uniform(0.5, 1.5, y.shape[:2]), dtype=dtype,
                         device=dev)
    args = (ss.phi, torch.diagonal(ss.q, 0, -2, -1).contiguous(), ss.z,
            ss.r, y, mask, bm, bc, sb, sb, cs.ADJ_SEG, False)
    got = ja.joint_adjoint(*args)
    want = ja.joint_adjoint_plain(*args)
    out["errs"][str(dtype)] = [cs.rel_err(g, w) for g, w in zip(got, want)]
rng = np.random.default_rng(cs.SEED + 95)
ss, y, mask = cs._adjoint_case(rng, cs.FLEET, cs.T_STEPS, torch.float32, dev)
bm, bc, _ = cs._boundaries("joint", ss, y, mask, cs.ADJ_SEG)
qd = torch.diagonal(ss.q, 0, -2, -1).contiguous()
sb = torch.ones(y.shape[:2], dtype=torch.float32, device=dev)
full = (ss.phi, qd, ss.z, ss.r, y, mask, bm, bc, sb, sb)
shaped = hasattr(ja, "block_shape")
auto = (getattr(ja, "ring_depth", None), getattr(ja, "block_shape", None))
def run(b, ring=0, shape=None):
    # a ring depth and a block shape forced through the wrapper's own
    # choosers, then restored
    if ring:
        ja.ring_depth = lambda *a: (ring, False)
    if shape:
        ja.block_shape = lambda *a: shape
    try:
        args = [t[:b].contiguous() for t in full]
        return cs.cuda_ms(lambda: ja.joint_adjoint_kernel(
            *args, cs.ADJ_SEG, False), reps=3, warm=1)[0]
    finally:
        if shaped:
            ja.ring_depth, ja.block_shape = auto
for b in (512, 64, 8, 1):
    out["ms"][str(b)] = run(b)
if shaped:
    n_seg = -(-cs.T_STEPS // cs.ADJ_SEG)
    ring, spill = ja.ring_depth(20, 21, torch.float32, n_seg)
    out["ring"] = {"R": ring, "spill": spill,
                   "smem_bytes": ja.smem_bytes(20, 21, torch.float32, ring),
                   "ring_bytes_b512": 4 * int(np.prod(ja.scratch_shape(
                       512, cs.T_STEPS, cs.ADJ_SEG, 20, 21, ring)))}
    for name, shape in (("compact", ja.COMPACT), ("wide", ja.WIDE)):
        out["ring"][f"blocks_per_sm_{name}"] = ja.occupancy(
            20, 21, torch.float32, ring, spill, *shape)
        out["ring"][f"blocks_per_sm_{name}_f64"] = ja.occupancy(
            20, 21, torch.float64, *ja.ring_depth(20, 21, torch.float64,
                                                  n_seg), *shape)
        out["ring"][f"shape_{name}"] = list(shape)
    out["by_shape"] = {f"{b}/R{r}/G{g}S{s}": run(b, r, (g, s))
                       for b in (512, 64, 1) for r in (2, 4)
                       for g, s in (ja.COMPACT, ja.WIDE)}
out["ptxas"] = build.build_info.get("ptxas", {}).get("joint_adjoint.cu", "")
print("RESULT " + json.dumps(out))
'''


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = Path(sys.argv[1]).resolve()
    here = Path(__file__).resolve().parents[1]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": smi.strip()}))
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
        ptxas = res.pop("ptxas")
        if name == "this" and ptxas:
            print(ptxas[-3000:])
        runs.append(res)
        print(json.dumps(res))
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
