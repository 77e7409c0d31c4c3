"""Run one cell of BENCHMARK.json once on the NVIDIA GPU of this machine
and print its result as the last line of standard output:

    python3 gpubench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

--trace 0 reports the cell's end-to-end metrics, --trace 1 its
per-layer ones (stage timers over the window, the profiler over a short
stretch in its middle).  Without a CUDA device, or with fewer than the
cell asks for, it exits with code 2 and prints no result; it never runs
on the CPU.  If the process has loaded jax, jaxlib, flax or openjph_tpu
by the end, it exits with code 3 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# kernel caches at fixed paths inside the checkout (the port builds its
# own kernels into <checkout>/build/openjph_tpu_torch/)
for _var, _sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                   ('TRITON_CACHE_DIR', 'triton')):
    os.environ[_var] = os.path.join(ROOT, 'build', 'gpubench', _sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from gpubench.harness import guard, manifest
    cell = manifest.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA device(s); '
              f'this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    from gpubench.harness.cell import run_cell
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device='cuda', t_start=T_START)
    bad = guard.loaded_banned()
    if bad:
        print(f'banned modules loaded: {bad}', file=sys.stderr)
        return 3
    for line in out.check_lines:
        print(line, file=sys.stderr)
    print(out.line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
