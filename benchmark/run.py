"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits non-zero and prints no result without
the CUDA cards the cell asks for, or if JAX or the JAX package was loaded.
The kernel build of the program and every other cache stay inside the
checkout.
"""
import os
import sys
import time

T0 = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    from benchmark import harness

    sys.exit(harness.main(sys.argv[1:], T0))
