"""What the drivers share: a run's context, the cfg handed to the
program, and the reference's view of an input batch."""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch


@dataclass
class Context:
    cell: str
    workload: dict
    config: dict
    seed: int
    device: torch.device
    trace: bool
    root: str
    fault: str | None = None


def cfg_path(ctx):
    """The configuration's Darknet cfg as a file for the program, written
    to a fixed path inside the benchmark folder."""
    d = os.path.join(ctx.root, '.cache', 'cfg')
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f'{ctx.config["name"]}.cfg')
    text = '\n'.join(ctx.config['darknet_cfg']) + '\n'
    if not os.path.exists(path) or open(path).read() != text:
        with open(path + '.tmp', 'w') as f:
            f.write(text)
        os.replace(path + '.tmp', path)
    return path


def nchw(images_u8):
    """uint8 NHWC images -> the network's f32 NCHW input, x / 256."""
    return images_u8.permute(0, 3, 1, 2).float() / 256.0


def fp8(t):
    """Round to float8 e4m3 (saturating at its largest finite, 448) and
    back: the control one precision below bf16. The gradient passes
    straight through, in t's dtype."""
    q = t.detach().clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(t.dtype)
    return t + (q - t).detach()


def sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
