"""The benchmark of ``yolo_tpu_torch`` on CUDA cards.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

runs one cell of ``BENCHMARK.json`` from the root of a checkout: set-up
(inputs and weights from the seed, the program built and warmed up on
every shape the cell uses), a measured window of ``--seconds``, then the
check of what the window produced against the plain reference
(``benchmark/reference``). The last line of standard output is one JSON
object; the last lines of standard error give each number compared
beside its limit.

Everything of a cell is data or a file of its own, found by name:
``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``), its driver (``drivers/<kind>.py``) and its
traffic; each per-layer metric of ``BENCHMARK.json`` is read by
``metrics/<metric>.py``. ``--trace 1`` profiles a fixed number of steps
right after the window, on the same warm state, and reports the cell's
per-layer metrics in place of its end-to-end ones.
"""

import time

T0 = time.perf_counter()

import argparse          # noqa: E402
import gc                # noqa: E402
import importlib.util    # noqa: E402
import json              # noqa: E402
import os                # noqa: E402
import sys               # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'yolo_tpu')


def load_module(path, name):
    """A module from a file of the benchmark, found by its name."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_metrics(bench, cell):
    """The cell's end-to-end and per-layer entries of ``BENCHMARK.json``:
    an entry with ``workloads`` where it lists the cell; a per-layer one
    without, where the cell reports the end-to-end metric it moves."""
    e2e = [m for m in bench['end_to_end'] if cell in m.get('workloads', [cell])]
    names = {m['name'] for m in e2e}

    def listed(m):
        return cell in m['workloads'] if 'workloads' in m else m['moves'] in names
    return e2e, [m for m in bench['per_layer'] if listed(m)]


def keep_caches_inside():
    """Every build and kernel cache of a run stays inside the checkout, at
    fixed paths, so that only a checkout's first run builds."""
    cache = os.path.join(HERE, '.cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache, 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')


def forbidden_modules():
    return sorted({m.split('.')[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run(cell, seed, seconds, trace, *, device='cuda', root=HERE,
        bench_file=None, t0=None, fault=None):
    """One run of ``cell``; returns the result object and every number
    that ``check`` of the cell's ``drivers/<kind>.py`` worked out (those
    without a limit are not compared: the readings a limit is set from).
    ``root`` is the benchmark folder; ``fault`` (the tests,
    ``benchmark.control``) breaks the timed path in the way that
    ``drivers/<kind>.py`` names."""
    import torch
    from . import trace as trace_mod
    from .common import Context
    t0 = time.perf_counter() if t0 is None else t0
    bench = load_json(bench_file or os.path.join(os.path.dirname(root),
                                                 'BENCHMARK.json'))
    wl = load_json(root, 'workloads', f'{cell}.json')
    cfg = load_json(root, 'configs', f'{wl["config"]}.json')
    driver = load_module(os.path.join(root, 'drivers', f'{wl["driver"]}.py'),
                         f'bench_driver_{wl["driver"]}')
    e2e, layer = cell_metrics(bench, cell)
    dev = torch.device(device)
    if dev.type == 'cuda':
        # the configurations' float32 is IEEE f32: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ctx = Context(cell=cell, workload=wl, config=cfg, seed=seed, device=dev,
                  trace=bool(trace), root=root, fault=fault)
    state = driver.setup(ctx)
    if dev.type == 'cuda':
        torch.cuda.synchronize()
    # what set-up made is never garbage: the window's collections then
    # scan only what the window makes
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0

    lat, items, i = [], 0, 0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        s = time.perf_counter()
        items += driver.step(state, i)
        lat.append(time.perf_counter() - s)
        i += 1
    driver.finish(state)
    window_s = time.perf_counter() - start
    if trace:
        # after the window, on the same warm state: device activity alone
        # over n steps for the metrics, then host activity too over n
        # more for the names of the idle gaps
        n = wl['trace']['steps']
        stretches = [trace_mod.Stretch(driver.RANGES, host=h)
                     for h in (False, True)]
        for st in stretches:
            st.start()
            for _ in range(n):
                driver.step(state, i)
                i += 1
            st.stop()
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda'
            else 0)

    # the numbers of drivers/<kind>.py; those the workload gives a limit are compared
    numbers = driver.check(state)
    checked = {k: v for k, v in numbers.items() if v[1] is not None}
    correct = all(v <= lim for v, lim in checked.values())
    result = {'correct': correct, 'attempted': i, 'failed': 0}
    window = {'seconds': window_s, 'steps': len(lat), 'items': items,
              'latency_s': lat, 'setup_s': setup_s}
    if not trace:
        # a name qualified after its first dot (``images_per_s.<cells>``)
        # is the driver's quantity of the unqualified name, under a bound
        # of its own
        values = driver.end_to_end(window)
        result['metrics'] = {
            m['name']: {'value': values[m['name'].split('.')[0]],
                        'unit': m['unit']} for m in e2e}
    else:
        rec = {**stretches[0].device(), **driver.record(state, window),
               'steps': n, 'window_step_s': window_s / len(lat)}
        result['metrics'] = {}
        for m in layer:
            reader = load_module(os.path.join(root, 'metrics',
                                              f'{m["name"]}.py'),
                                 f'bench_metric_{m["name"]}')
            v = reader.read(rec)
            if v is not None:
                result['metrics'][m['name']] = {'value': v, 'unit': m['unit']}
        result['breakdown'] = {'device_ops': rec['device_ops'],
                               'idle_gaps': stretches[1].idle_gaps()}
    result['device'] = {
        'platform': 'gpu' if dev.type == 'cuda' else dev.type,
        'kind': (torch.cuda.get_device_name(dev) if dev.type == 'cuda'
                 else dev.type),
        'count': 1, 'memory_peak_bytes': peak}
    if trace:
        result['device'].update(busy_s=rec['busy_s'], window_s=rec['window_s'])
    result['checked'] = {k: {'value': v, 'limit': lim}
                         for k, (v, lim) in checked.items()}
    return result, {k: v for k, (v, _) in numbers.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    keep_caches_inside()
    os.environ['USE_FLAX'] = '0'
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)
    import torch
    # one process with one host thread: the window's host work is the
    # launches, and idle worker threads only add noise
    torch.set_num_threads(1)
    cells = load_json(CHECKOUT, 'BENCHMARK.json')['workloads']
    chips = next(c['chips'] for c in cells if c['name'] == args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f'benchmark: {chips} CUDA device(s) needed, {have} available',
              file=sys.stderr)
        return 2
    result, _ = run(args.workload, args.seed, args.seconds, args.trace,
                    t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f'benchmark: the run loaded {", ".join(bad)}', file=sys.stderr)
        return 3
    for k, c in result['checked'].items():
        print(f'check {k}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    print(f'correct: {result["correct"]}', file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
