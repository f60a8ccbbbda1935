'''
The readings that set a cell's limits: for each seed, the program's run
through set-up and its check against the reference; for the control
seeds also the control (the reference one precision below the
configuration's, in the program's place) and each fault the cell can
have, planted in the reference put in the program's place.  One JSON
line a seed on standard output.

    python3 bench_torch/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 0]
'''
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--seconds', type=float, default=0.0)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--reduced', action='store_true',
                    help='the rehearsal\'s size (for a CPU try-out)')
    args = ap.parse_args()
    import torch
    from lib import harness
    bench = harness.benchmark()
    cell = harness.cell_of(bench, args.workload)
    cfg = harness.config(cell['config'])
    mx = harness.mix(cell['traffic'])
    if args.reduced:
        from lib import rehearse
        cfg, mx = rehearse.reduced(cfg, mx)
    dev = torch.device(args.device)
    if dev.type == 'cuda':
        harness.require_cards(int(cell['chips']))
    mod = harness.runner(mx['kind'])
    controls = {int(s) for s in args.control_seeds.split(',') if s}
    for s in (int(x) for x in args.seeds.split(',')):
        t = time.perf_counter()
        drv = mod.Runner(cfg, mx, s, dev)
        drv.setup()
        t_setup = time.perf_counter() - t
        if args.seconds > 0:
            drv.window(args.seconds, False)
        drv.release()
        t = time.perf_counter()
        rec = {'seed': s, 'setup_s': t_setup, 'program': drv.check()}
        rec['check_s'] = time.perf_counter() - t
        if s in controls:
            rec.update(drv.faults())
        print(json.dumps(rec), flush=True)
        del drv
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
    print('calibrate: %.1f s' % (time.perf_counter() - T0), file=sys.stderr)


if __name__ == '__main__':
    main()
