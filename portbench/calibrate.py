"""Readings for the limits of ``correct``, on the card, in one process:
the program's numbers over many seeds (the lower readings) and the
control's (the reference in the nearest lower precision in the program's
place: its tracer in bfloat16, its scorer with TF32 inputs; the upper
readings).  The benchmark's own runs never run this.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds 1 2 3 ... [--control-seeds 7 8 9] [--out FILE]

Each run is a whole ``run_cell`` (warm job, a window of ``--seconds``,
the comparison); one JSON line per run goes to standard output and, with
``--out``, to FILE.  Give a window that holds at least the cell's
``sample_jobs`` jobs, as a benchmark run does.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import load_cell, run_cell

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(1)     # as portbench/run.py
    device = torch.device("cuda", 0)
    cell = load_cell(Path.cwd(), args.workload)
    out = open(args.out, "a") if args.out else None
    try:
        for side, seeds in (("Program", args.seeds),
                            ("Control", args.control_seeds)):
            for seed in seeds:
                t0 = time.perf_counter()
                try:
                    r = run_cell(cell, seed, args.seconds, False, device,
                                 side=side)
                    line = {"side": side, "seed": seed,
                            "correct": r["correct"],
                            "attempted": r["attempted"],
                            "failed": r["failed"], "checks": r["checks"],
                            "metrics": r["metrics"]}
                except Exception as exc:   # a control that crashes failed
                    line = {"side": side, "seed": seed, "error": repr(exc)}
                line["workload"] = args.workload
                line["wall_s"] = time.perf_counter() - t0
                text = json.dumps(line)
                print(text, flush=True)
                if out:
                    out.write(text + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    sys.exit(main())
