"""Whole runs of the harness on the CPU, on tiny cells dropped into a copy
of the folder as data files (``conftest.py``): found without a code edit,
``correct`` true for the program, false for the control (the reference a
precision lower, in the program's place) and for each fault the cell can
have, planted under the timed path. The harness's own look for a card is
skipped: ``run`` is called with the CPU."""

import json
import os

import pytest

from conftest import TINY

from benchmark import run as harness

SEED = 2 ** 31 + 12345
SERVE = ['tiny.int8-serve', 'tiny.int8-serve-cos', 'tiny.bf16-serve',
         'tiny-mobile.int8-serve']


def tiny_run(root, cell, fault=None, trace=0):
    return harness.run(cell, SEED, 0.3, trace, device='cpu', root=root,
                       fault=fault)[0]


@pytest.mark.parametrize('cell', list(TINY))
def test_program_is_correct(tiny_root, cell):
    r = tiny_run(tiny_root, cell)
    assert r['correct'], r['checked']
    assert r['attempted'] >= 1 and r['failed'] == 0
    assert 'setup_s' in r['metrics'] and len(r['metrics']) >= 2
    assert list(r)[-1] == 'checked'
    json.dumps(r)


FAULTS = ([(c, f) for c in SERVE for f in ('control', 'half', 'alter', 'scale')]
          + [('tiny.train', f)
             for f in ('control', 'unchanged', 'half', 'ema', 'bn')])


@pytest.mark.parametrize('cell,fault', FAULTS)
def test_control_and_faults_are_not_correct(tiny_root, cell, fault):
    r = tiny_run(tiny_root, cell, fault)
    assert not r['correct'], r['checked']


@pytest.mark.parametrize('cell', ['tiny.int8-serve', 'tiny.train'])
def test_traced_run_reports_per_layer_metrics(tiny_root, cell):
    r = tiny_run(tiny_root, cell, trace=1)
    assert r['correct']
    assert {'busy_s', 'window_s'} <= set(r['device'])
    mfu = 'serve_mfu' if 'serve' in cell else 'train_mfu'
    assert 0 < r['metrics'][mfu]['value'] < 100
    assert set(r['breakdown']) == {'device_ops', 'idle_gaps'}


def test_same_seed_same_inputs(tiny_root):
    a = tiny_run(tiny_root, 'tiny.train')
    b = tiny_run(tiny_root, 'tiny.train')
    assert a['checked'] == b['checked']


def test_a_dropped_in_metric_is_read(tiny_root):
    """A per-layer metric added as a file and an entry is reported."""
    path = os.path.join(tiny_root, 'metrics', 'steps_traced.py')
    with open(path, 'w') as f:
        f.write('def read(rec):\n    return float(rec["steps"])\n')
    bench_file = os.path.join(os.path.dirname(tiny_root), 'BENCHMARK.json')
    bench = json.load(open(bench_file))
    bench['per_layer'].append({'name': 'steps_traced', 'unit': 'steps',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'harness', 'moves': 'images_per_s',
                               'workloads': ['tiny.bf16-serve']})
    extra = os.path.join(os.path.dirname(tiny_root), 'B2.json')
    json.dump(bench, open(extra, 'w'))
    r = harness.run('tiny.bf16-serve', SEED, 0.3, 1, device='cpu',
                    root=tiny_root, bench_file=extra)[0]
    assert r['metrics']['steps_traced']['value'] == 2.0


def test_no_card_no_result(capsys):
    """Without CUDA the command prints no result and fails."""
    if harness.__dict__.get('torch') is None:
        import torch
        if torch.cuda.is_available():
            pytest.skip('a card is present')
    rc = harness.main(['--workload', 'yolov3-608.int8-serve', '--seed', '1',
                       '--seconds', '1'])
    assert rc != 0 and capsys.readouterr().out == ''
