"""Run one cell of the port's benchmark once, on the card this machine has.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The run sets up (its inputs made from the seed,
the port's kernels built or found in ``build/``), measures its window,
compares what the window delivered with the plain reference, and prints the
result as the last line of its standard output: one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared beside
its limit. The same comparisons are the last lines of its standard error.

Without a card, or with fewer than the cell asks for, it prints no result and
exits with 2; with a JAX module loaded once the window has closed, with 3.
``--control`` puts the reference computed in bfloat16 in the program's place
(the lower-precision control; the benchmark's own runs never pass it).
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from gpubench import harness

    bench = harness.benchmark(ROOT)
    work = {w["name"]: w for w in bench["workloads"]}.get(args.workload)
    if work is None:
        print(f"gpubench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < work["chips"]:
        print(f"gpubench: {args.workload} needs {work['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import rodio_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"gpubench: the port is not importable here: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.make_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), control=args.control, start=START,
                             bench=bench)
    result, samples, lines = harness.run_cell(cell, bench)
    foreign = harness.foreign_modules()
    if foreign:
        print(f"gpubench: loaded in this process: {', '.join(foreign)}", file=sys.stderr)
        return 3
    for line in samples:
        print(line)
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
