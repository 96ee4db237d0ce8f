"""Run one cell of the altair_tpu_torch benchmark once, from the root of a
checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs as many CUDA cards as the cell asks for, and fails without them.
The last line of standard output is the result as one JSON object; the
numbers compared with the reference, each with its limit, are the last
lines of standard error.  See ``portbench/README.md``.
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parent.parent
    # the checkout's root, not this folder, is where imports start
    sys.path[0] = str(ROOT)
    from portbench.harness import main

    sys.exit(main())
