"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root, on a machine with the cell's CUDA devices.  The
cells, configurations, traffic mixes, limits and per-layer metrics are the
data files that ``BENCHMARK.json`` and ``benchmark/`` hold (``vbench/spec``).
"""

import os
import sys
import time

T_START = time.perf_counter()
# one busy thread: the frame loop is one Python thread, and idle OpenMP
# workers that spin after each parallel copy take cores from it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from vbench.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
