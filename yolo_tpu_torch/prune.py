"""Pruning CLI of the PyTorch port (counterpart of the root
``*_prune.py`` scripts, which belong to the JAX package):

    python -m yolo_tpu_torch.prune --method normal --cfg cfg/yolov3/yolov3.cfg \\
        --data data_cfg/coco2014.data --weights weights/last.npz \\
        --img-size 608 [--percent 0.5] [--device cpu]

``--method`` is one of normal, regular, shortcut, slim, layer,
layer_channel, layer_channel_regular, eagle_normal, eagle_regular and
eagle_slim (the EagleEye ones also take ``--remain-ratio``, ``--delta``
and ``--number``). The other flags are those of
``compress/prune_cli.py``. The pruned cfg is written beside the input
cfg, the compact weights to ``./weights/<tag>.weights``.
"""

from __future__ import annotations

import argparse

from .compress.prune_cli import METHODS, run_prune_cli


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument('--method', choices=METHODS, default='normal')
    opt, rest = p.parse_known_args(argv)
    return run_prune_cli(opt.method, rest)


if __name__ == '__main__':
    main()
