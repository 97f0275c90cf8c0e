"""Darknet ``.cfg`` / ``.data`` / ``.names`` parsing and the training
hyper-parameters.

The port's own copy of the parsers, ``DEFAULT_HYP`` and ``load_hyp`` in
``yolo_tpu/config.py`` (numpy only), with the reference parser's quirks
kept:

- ``anchors`` -> float ndarray reshaped (-1, 2).
- ``from``/``layers``/``mask`` (and comma ``size``) -> list[int].
- values that are pure digit strings -> int; anything else (including floats
  like ``0.9``) stays a *string* — downstream code casts where needed.
- a field whitelist is enforced over all blocks after ``[net]``.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

# Field whitelist of the reference parser, plus [dropout] 'probability' and
# 'share_index' (yolov3-spp-matrix.cfg), which are accepted and ignored.
SUPPORTED_FIELDS = [
    'type', 'batch_normalize', 'filters', 'size', 'stride', 'pad', 'activation',
    'layers', 'groups', 'reduction', 'from', 'mask', 'anchors', 'classes', 'num',
    'jitter', 'ignore_thresh', 'truth_thresh', 'random', 'stride_x', 'stride_y',
    'weights_type', 'weights_normalization', 'scale_x_y', 'beta_nms', 'nms_kind',
    'iou_loss', 'iou_normalizer', 'cls_normalizer', 'iou_thresh', 'group_id',
    'resize', 'probability', 'share_index',
]


def parse_model_cfg(path: str | os.PathLike) -> list[dict]:
    """Parse a Darknet .cfg into a list of block dicts (first block = [net])."""
    path = str(path)
    if not path.endswith('.cfg'):
        path += '.cfg'
    if not os.path.exists(path) and os.path.exists(os.path.join('cfg', path)):
        path = os.path.join('cfg', path)

    with open(path, 'r') as f:
        lines = f.read().split('\n')
    lines = [x for x in lines if x and not x.startswith('#')]
    lines = [x.strip() for x in lines]

    mdefs: list[dict] = []
    for line in lines:
        if line.startswith('['):
            mdefs.append({})
            mdefs[-1]['type'] = line[1:-1].rstrip()
            if mdefs[-1]['type'] == 'convolutional':
                # pre-populated; the block may overwrite it
                mdefs[-1]['batch_normalize'] = 0
        else:
            key, val = line.split('=')
            key = key.rstrip()
            if key == 'anchors':
                mdefs[-1][key] = np.array(
                    [float(x) for x in val.split(',')]).reshape((-1, 2))
            elif (key in ('from', 'layers', 'mask')) or (key == 'size' and ',' in val):
                mdefs[-1][key] = [int(x) for x in val.split(',')]
            else:
                val = val.strip()
                if val.isnumeric():
                    mdefs[-1][key] = int(val) if (int(val) - float(val)) == 0 else float(val)
                else:
                    mdefs[-1][key] = val

    fields: list[str] = []
    for blk in mdefs[1:]:
        for k in blk:
            if k not in fields:
                fields.append(k)
    unsupported = [x for x in fields if x not in SUPPORTED_FIELDS]
    if unsupported:
        raise ValueError(f'Unsupported fields {unsupported} in {path}')
    return mdefs


def parse_data_cfg(path: str | os.PathLike) -> dict[str, str]:
    """Parse a .data dataset descriptor (classes/train/valid/names keys)."""
    path = str(path)
    if not os.path.exists(path):
        for prefix in ('data', 'data_cfg'):
            cand = os.path.join(prefix, os.path.basename(path))
            if os.path.exists(cand):
                path = cand
                break
    options: dict[str, str] = {}
    with open(path, 'r') as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith('#'):
                continue
            key, val = line.split('=')
            options[key.strip()] = val.strip()
    return options


def load_classes(path: str | os.PathLike) -> list[str]:
    """Class names from a .names file, found by recursive glob when the
    given path does not exist (``.data`` files name ``data/foo.names``
    that live under ``data_cfg/``)."""
    path = str(path)
    if not os.path.exists(path):
        path = find_file(path)
    with open(str(path), 'r') as f:
        names = f.read().split('\n')
    return list(filter(None, names))


def find_file(path: str, roots: tuple[str, ...] = ('.', 'cfg', 'data_cfg', 'data')) -> str:
    """``path`` if it exists, else the first file of its basename found by
    recursive glob under ``roots``."""
    if os.path.exists(path):
        return path
    base = os.path.basename(path)
    for root in roots:
        if not os.path.isdir(root):
            continue
        hits = sorted(Path(root).rglob(base))
        if hits:
            return str(hits[0])
    raise FileNotFoundError(path)


# Default training hyper-parameters (the coco-tuned set of the JAX package).
DEFAULT_HYP = {
    'giou': 3.54,        # giou loss gain
    'cls': 37.4,         # cls loss gain
    'cls_pw': 1.0,       # cls BCELoss positive_weight
    'obj': 64.3,         # obj loss gain (*=img_size/320 if img_size != 320)
    'obj_pw': 1.0,       # obj BCELoss positive_weight
    'iou_t': 0.20,       # iou training threshold
    'lr0': 0.001,        # initial learning rate
    'lrf': 0.0005,       # final learning rate
    'momentum': 0.937,
    'weight_decay': 0.000484,
    'fl_gamma': 0.0,     # focal loss gamma
    'hsv_h': 0.0138,     # image HSV-Hue augmentation (fraction)
    'hsv_s': 0.678,      # image HSV-Saturation augmentation (fraction)
    'hsv_v': 0.36,       # image HSV-Value augmentation (fraction)
    'degrees': 1.98 * 0, # image rotation (+/- deg)
    'translate': 0.05 * 0,
    'scale': 0.05 * 0,
    'shear': 0.641 * 0,
}


def load_hyp(hyp_txt: str | None = None) -> dict:
    """``DEFAULT_HYP``, with the values of a hyp*.txt file (two header
    lines, then ``name value`` rows) over it."""
    hyp = dict(DEFAULT_HYP)
    if hyp_txt:
        for line in Path(hyp_txt).read_text().splitlines()[2:]:
            parts = line.split()
            if len(parts) >= 2:
                hyp[parts[0]] = float(parts[1])
    return hyp
