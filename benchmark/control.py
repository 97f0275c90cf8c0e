"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m benchmark.control --workload NAME --seconds S \
        --fault FAULT --seeds N [N ...]

runs the cell once a seed with the timed path broken as the cell's
``drivers/<kind>.py`` names the fault (``control``: the reference one
precision below the configuration's, in the program's place; ``none``:
the program as it is; serving also ``half``, ``alter``, ``scale``;
training ``unchanged``, ``ema``, ``bn``, ``half``), all in one process,
and prints each run's numbers, compared or not, as one JSON line. A broken run is never a benchmark result: this is a tool for
setting and re-checking the limits, not part of a cell's run.
"""

import argparse
import json
import sys

from benchmark.run import keep_caches_inside, run


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, default=2.0)
    p.add_argument('--fault', default='control')
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    args = p.parse_args(argv)
    keep_caches_inside()
    fault = None if args.fault == 'none' else args.fault
    import torch
    torch.set_num_threads(1)
    for seed in args.seeds:
        r, numbers = run(args.workload, seed, args.seconds, 0, fault=fault)
        print(json.dumps({'workload': args.workload, 'fault': args.fault,
                          'seed': seed, 'correct': r['correct'],
                          'numbers': numbers, 'metrics': r['metrics']}),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
