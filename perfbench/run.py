"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The program under test is the
PyTorch port, ``src/repro_torch``; nothing here imports JAX or the JAX
package.  The port builds its kernels once into ``build/torch_kernels``
inside the checkout, where every later run finds them.
"""
import time

T_PROCESS = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]

from harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T_PROCESS))
