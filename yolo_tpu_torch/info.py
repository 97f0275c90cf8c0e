"""Model summary CLI of the PyTorch port (counterpart of the root
``info.py``, which belongs to the JAX package): the per-layer table, the
parameter count and GFLOPs, from the cfg's IR alone.

    python -m yolo_tpu_torch.info --cfg cfg/yolov3/yolov3.cfg --img-size 608

Nothing runs on a device, so ``--device`` is accepted and has no effect.
"""

from __future__ import annotations

from .utils.cli import FlexParser


def main(argv=None):
    p = FlexParser()
    p.add_argument('--cfg', type=str, default='cfg/yolov3/yolov3.cfg')
    p.add_argument('--img-size', type=int, default=416)
    p.add_argument('--device', type=str, default='',
                   help='accepted for CLI compatibility; the summary is '
                        'computed from the IR on the host')
    opt = p.parse_args(argv)

    from .ir import build_ir
    from .utils.profiling import model_info

    net = build_ir(opt.cfg)
    print(f'{"idx":>4} {"type":<12} {"filters":>8} {"size":>5} {"stride":>6} '
          f'{"bn":>3} {"activation":>10}')
    for l in net.layers:
        print(f'{l.index:>4} {l.kind:<12} {l.filters:>8} {l.size:>5} '
              f'{l.stride:>6} {int(l.bn):>3} {l.activation:>10}')
    info = model_info(net, opt.img_size)
    print(f"\nModel Summary: {info['layers']} layers, "
          f"{info['params'] / 1e6:.2f}M parameters, "
          f"{info['gflops']:.1f} GFLOPs @ {opt.img_size}")
    return info


if __name__ == '__main__':
    main()
