"""Count fresh processes whose first threaded CPU float call comes back
inexact.

Each process calls `torch.sqrt` on 65,536 ones (a call torch splits over
its OpenMP threads) as its first float vector-math call, optionally after
one single-element call of another function, and reports how many lanes
are not exactly 1. Processes start `--batch` at a time, for load.

    python tools/cpu_first_call.py --first none --runs 120
    python tools/cpu_first_call.py --first exp --runs 120
    python tools/cpu_first_call.py --first settle --runs 120

`settle` is the port's `core/cpu_math.settle()`.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FIRST = {
    "none": "",
    "sqrt": "torch.sqrt(torch.full((1,), 0.5))\n",
    "exp": "torch.exp(torch.full((1,), 0.5))\n",
    "settle": ("from rlshaders_tpu_torch.core import cpu_math\n"
               "cpu_math.settle()\n"),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--first", choices=sorted(FIRST), default="none")
    ap.add_argument("--runs", type=int, default=120)
    ap.add_argument("--batch", type=int, default=40)
    args = ap.parse_args()
    code = ("import torch\n" + FIRST[args.first]
            + "y = torch.sqrt(torch.ones(1 << 16))\n"
            "print(int((y != 1).sum()), float(y.min()))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    bad, lanes = 0, set()
    for start in range(0, args.runs, args.batch):
        procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                                  stdout=subprocess.PIPE, text=True)
                 for _ in range(min(args.batch, args.runs - start))]
        for proc in procs:
            out, _ = proc.communicate(timeout=600)
            n, low = out.split()
            if int(n):
                bad += 1
                lanes.add((int(n), float(low)))
    print(f"first={args.first}: {bad} of {args.runs} processes inexact; "
          f"(lanes, min) {sorted(lanes)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
