"""gsutil bucket copies of the training artifacts (the port's copy of
``yolo_tpu/utils/gsutil.py``): ``results.txt`` after each epoch, the
shared ``evolve.txt`` of hyper-parameter evolution, and the checkpoints at
the end of training.

Each transfer is one ``gsutil cp`` through ``runner``, which tests replace
to see the exact commands. A failed or missing ``gsutil`` is logged and
training goes on.
"""

from __future__ import annotations

import os
import subprocess


def _run(cmd):
    try:
        return subprocess.run(cmd, check=False).returncode
    except OSError as e:          # gsutil not installed
        print(f'gsutil sync skipped: {e}')
        return -1


runner = _run   # tests replace this


def cp(src, dst):
    """``gsutil cp src dst`` (either side may be a gs:// URI)."""
    return runner(['gsutil', 'cp', str(src), str(dst)])


def sync_results(bucket: str, name: str, results_file='results.txt'):
    """The epoch's results file to ``gs://bucket/results/results<name>.txt``."""
    if bucket and name:
        cp(results_file, f'gs://{bucket}/results/results{name}.txt')


def download_evolve(bucket: str, evolve_file='evolve.txt'):
    """The bucket's shared ``evolve.txt``, before a mutation."""
    if bucket:
        cp(f'gs://{bucket}/evolve.txt', evolve_file)


def upload_evolve(bucket: str, evolve_file='evolve.txt'):
    """The appended ``evolve.txt`` back to the bucket."""
    if bucket:
        cp(evolve_file, f'gs://{bucket}/evolve.txt')


def upload_weights(bucket: str, path):
    """A checkpoint to ``gs://bucket/weights/<its name>``: the object is
    named, so a second upload does not overwrite the first on a bucket
    without a ``weights/`` prefix yet."""
    if bucket:
        cp(path, f'gs://{bucket}/weights/{os.path.basename(str(path))}')
