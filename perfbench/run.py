"""Run one benchmark cell: ``python3 perfbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Exits non-zero, printing no result, without as many CUDA cards as the cell
asks for, when the program cannot be imported, or when the run loaded JAX or
the JAX package.  Kernel builds stay inside the checkout (``build/``).
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

if __name__ == "__main__":
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    from perfbench import harness

    harness.main(t_start=T_START)
