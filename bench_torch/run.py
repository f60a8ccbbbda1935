'''
The port's benchmark: one run of one cell.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

prints the result as the last line of standard output (JSON) and each
number the check compared, with its limit, as the last lines of
standard error.  ``--rehearse`` instead runs every cell's path on the CPU
at a reduced size with the program's plain versions, checks the
yardstick's arithmetic on hand-worked cases, and prints no device
metric.  The chip path needs a CUDA card and fails without one.
'''
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# any Triton cache of the program stays in the checkout, at a fixed path
os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(
    ROOT, 'mfrec_tpu_torch', '_build', 'triton'))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--seconds', type=float, default=10.0)
    ap.add_argument('--trace', type=int, default=0)
    ap.add_argument('--rehearse', action='store_true')
    args = ap.parse_args(argv)
    if args.rehearse:
        from lib import rehearse
        return rehearse.main()
    if not args.workload:
        ap.error('--workload is required')
    from lib import harness
    return harness.run(args, T_START)


if __name__ == '__main__':
    sys.exit(main())
