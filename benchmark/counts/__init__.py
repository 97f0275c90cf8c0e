"""Operations and bytes of the benchmark's kernels, from the cfg's shapes,
and the published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates): the numerators and denominators of the roofline shares and
of the whole step's share of the peak.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the peak rate for their type; each input byte is read
once and each output byte written once; a multiply-add is 2 operations.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12


def bound_ms(n_bytes, n_ops, ops_per_s):
    """The least time in ms of moving ``n_bytes`` and doing ``n_ops``."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s) * 1e3


def conv_ops(convs, bs):
    """Operations of every conv of a batch of ``bs``: ``convs`` as
    ``reference.darknet.macs`` lists them."""
    return 2.0 * bs * sum(c[3] for c in convs)


def k2_calls(convs):
    """The convs K2 runs in the int8 engine: all but the float stem."""
    return convs[1:]


def k2_bound_ms(convs, bs):
    """K2's bound for one batch: each int8 conv's input, weights and f32
    bias read once, its int8 output written once."""
    total = 0.0
    for lyr, h_in, h_out, macs in k2_calls(convs):
        n_bytes = (bs * h_in * h_in * lyr.cin + lyr.cout * lyr.size ** 2
                   * lyr.cin + 4 * lyr.cout + bs * h_out * h_out * lyr.cout)
        total += bound_ms(n_bytes, 2.0 * bs * macs, INT8_OPS_PER_S)
    return total


def k1_bound_ms(bs, k, valid_per_image, overlapping_pairs=0):
    """K1's bound for one batch of ``bs`` images of ``k`` candidates: the
    class-offset and raw boxes, the scores and the valid flags read once,
    keep and the merged boxes written once; 14 f32 operations an IoU of a
    pair of valid candidates, 4 a valid row, 9 an overlapping pair of the
    merge."""
    n_bytes = bs * k * (16 + 16 + 4 + 1) + bs * k * (1 + 16)
    n_ops = sum(v * (v - 1) / 2 * 14 + v * 4 for v in valid_per_image)
    return bound_ms(n_bytes, n_ops + 9 * overlapping_pairs, F32_OPS_PER_S)
