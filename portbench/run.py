#!/usr/bin/env python3
"""The benchmark of rlshaders_tpu_torch, one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. Prints the result as one JSON line, the
last of standard output, and each number of the output check beside its
limit as the last lines of standard error. Exits 2 without a card (or with
fewer than the cell needs), and non-zero on any other failure, printing no
result. The program's kernel caches stay inside the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def environment() -> None:
    """Cache directories inside the checkout, at fixed paths; no JAX by
    way of a library; the checkout and the reference on the path."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (ROOT / "portbench" / "reference", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    from portbench import harness

    before = harness.since_start() - (time.perf_counter() - T0)
    try:
        line = harness.run(args.workload, args.seed, args.seconds,
                           args.trace, t0=T0, before=max(before, 0.0))
    except harness.NoCard as e:
        print(f"portbench: cannot measure: {e}", file=sys.stderr)
        return 2
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
