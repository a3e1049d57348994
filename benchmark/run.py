"""One run of one benchmark cell of the PyTorch/CUDA port:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result as one JSON object; the numbers compared with the reference, each
beside its limit, are the last lines of standard error.  Exits with 2, and
prints no result, without as many CUDA devices as the cell needs.
"""

import os
import sys
import time

T_PROCESS = time.perf_counter()

_BENCH = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_BENCH)
_CACHE = os.path.join(_ROOT, "_bench_cache")
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = os.path.join(_CACHE, sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [_BENCH, _ROOT]

if __name__ == "__main__":
    from harness.core import main

    sys.exit(main(t_process=T_PROCESS))
