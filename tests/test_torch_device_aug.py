"""The port's device augmentation (``yolo_tpu_torch.data.device_aug``)
against ``yolo_tpu.data.device_aug`` on the CPU.

The port draws from a ``torch.Generator`` and JAX from ``jax.random``, so
the arithmetic is held to JAX's given JAX's own draws: the test recovers
them from JAX's key by JAX's splits (``make_device_augment``'s four keys,
the mosaic offsets, one key an image split in eight for the affine, the
HSV uniforms, the flips) and hands them to ``DeviceAugment.apply``. The
draws themselves are held to JAX's in statistics.
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_port import jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.fixture(scope='module', autouse=True)
def _jax_native_loaded():
    """JAX's ``BatchLoader`` takes its native path where ``yolo_tpu.native``
    loads: load it whichever test process built it
    (``_torch_port.jax_native``)."""
    jax_native()

S, BS, T = 64, 4, 12
# the default hyps' gains with a scale of 0.5 (the resampling shrinks, so
# its antialiased kernel is exercised) and a translation
HYP = dict(hsv_h=0.0138, hsv_s=0.678, hsv_v=0.36, translate=0.1, scale=0.5)


def _batch(seed):
    """Images (BS, S, S, 3) in [0, 1] and targets of big boxes (three an
    image, centred away from the edges) with three invalid rows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:S, 0:S] / S
    base = np.stack([np.sin(6 * xx), np.cos(5 * yy), np.sin(4 * (xx + yy))],
                    -1)
    imgs = np.clip(0.5 + 0.3 * base + rng.normal(0, 0.1, (BS, S, S, 3)),
                   0, 1).astype(np.float32)
    tgt = np.zeros((T, 6), np.float32)
    n = 3 * BS
    tgt[:n, 0] = np.repeat(np.arange(BS), 3)
    tgt[:n, 1] = rng.integers(0, 3, n)
    tgt[:n, 2:4] = rng.uniform(0.3, 0.7, (n, 2))
    tgt[:n, 4:6] = rng.uniform(0.25, 0.45, (n, 2))
    valid = np.zeros(T, bool)
    valid[:n - 3] = True
    return imgs, tgt, valid


def _jax_draws(key, hyp, mosaic):
    """JAX's draws for ``key``, by ``make_device_augment``'s own splits,
    in the port's layout."""
    import jax
    u = jax.random.uniform
    k_m, k_aff, k_hsv, k_flip = jax.random.split(key, 4)
    deg, tr = hyp.get('degrees', 0.0), hyp.get('translate', 0.0)
    sc, sh = hyp.get('scale', 0.0), hyp.get('shear', 0.0)
    jit = S / 2.0 if mosaic else 0.0
    aff = []
    for k in jax.random.split(k_aff, BS):
        ka, ks, ktx, kty, ksx, ksy, kwx, kwy = jax.random.split(k, 8)
        aff.append([u(ka, (), minval=-deg, maxval=deg),
                    u(ks, (), minval=1 - sc, maxval=1 + sc),
                    u(ktx, (), minval=-tr, maxval=tr),
                    u(kty, (), minval=-tr, maxval=tr),
                    u(ksx, (), minval=-sh, maxval=sh),
                    u(ksy, (), minval=-sh, maxval=sh),
                    u(kwx, (), minval=-jit, maxval=jit),
                    u(kwy, (), minval=-jit, maxval=jit)])
    return {
        'offs': torch.from_numpy(np.array(
            jax.random.randint(k_m, (3,), 1, max(BS, 2))).astype(np.int64)),
        'affine': torch.from_numpy(np.array(aff, np.float32)),
        'hsv': torch.from_numpy(np.array(
            u(k_hsv, (3,), minval=-1.0, maxval=1.0))),
        'flips': torch.from_numpy(np.array(
            jax.random.bernoulli(k_flip, 0.5, (BS,))))}


_JAX_AUGS = {}


def _jax_augment(hyp, mosaic):
    """JAX's jitted augmentation for (hyp, mosaic), compiled once a
    module."""
    from yolo_tpu.data.device_aug import make_device_augment as jmake
    key = (tuple(sorted(hyp.items())), mosaic)
    if key not in _JAX_AUGS:
        _JAX_AUGS[key] = jmake(S, hyp, mosaic=mosaic)
    return _JAX_AUGS[key]


def test_hsv_conversions_match_jax():
    import jax
    import jax.numpy as jnp
    from yolo_tpu.data import device_aug as J
    from yolo_tpu_torch.data import device_aug as D
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (4000, 3)).astype(np.float32)
    x[:500] = x[:500, :1]                       # gray: d == 0
    x[500:600, 0] = x[500:600, 1]               # ties in the max
    x[600:700] = 0.0
    hsv = D.rgb_to_hsv(torch.from_numpy(x))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jax.jit(J.rgb_to_hsv)(
        jnp.asarray(x))), atol=1e-6, rtol=0)
    h = rng.uniform(0, 1, (4000, 3)).astype(np.float32)
    h[:100, 0] = 1.0 - 1e-7                     # i = 6 wraps to 0
    np.testing.assert_allclose(
        D.hsv_to_rgb(torch.from_numpy(h)).numpy(),
        np.asarray(jax.jit(J.hsv_to_rgb)(jnp.asarray(h))), atol=1e-6, rtol=0)


@pytest.mark.parametrize('mosaic', [True, False])
@pytest.mark.parametrize('warp', ['scale_translate', 'general'])
def test_apply_matches_jax_given_its_draws(mosaic, warp):
    import jax
    import jax.numpy as jnp
    from yolo_tpu_torch.data.device_aug import make_device_augment
    hyp = dict(HYP, **({'degrees': 10.0, 'shear': 5.0}
                       if warp == 'general' else {}))
    imgs, tgt, valid = _batch(1)
    key = jax.random.PRNGKey(7)
    with jax.default_matmul_precision('highest'):
        want = _jax_augment(hyp, mosaic)(
            jnp.asarray(imgs), jnp.asarray(tgt), jnp.asarray(valid), key)
        want = [np.asarray(w) for w in want]
    got = make_device_augment(S, hyp, mosaic=mosaic).apply(
        torch.from_numpy(imgs), torch.from_numpy(tgt),
        torch.from_numpy(valid), _jax_draws(key, hyp, mosaic))
    got = [g.numpy() for g in got]
    assert got[0].shape == want[0].shape == (BS, S, S, 3)
    assert got[1].shape == want[1].shape == (T, 6)
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
    assert 0 < want[2].sum() <= (4 if mosaic else 1) * valid.sum()


def test_draws_match_jax_in_statistics():
    """Over 32 seeds on each side: every draw in its range, every offset
    value and both flip outcomes drawn, and the share of boxes that
    survive within 0.05 of JAX's."""
    import jax
    import jax.numpy as jnp
    from yolo_tpu_torch.data.device_aug import make_device_augment
    hyp = dict(HYP, degrees=10.0, shear=5.0)
    imgs, tgt, valid = _batch(2)
    aug, jaug = make_device_augment(S, hyp), _jax_augment(hyp, True)
    x, t, v = (torch.from_numpy(a) for a in (imgs, tgt, valid))
    lo = torch.tensor([-10, 0.5, -0.1, -0.1, -5, -5, -S / 2, -S / 2])
    hi = torch.tensor([10, 1.5, 0.1, 0.1, 5, 5, S / 2, S / 2])
    kept, jkept, offs, flips = 0, 0, set(), set()
    for seed in range(32):
        g = torch.Generator().manual_seed(seed)
        d = aug.draw(BS, g)
        assert ((d['affine'] >= lo) & (d['affine'] <= hi)).all()
        assert ((d['hsv'] >= -1) & (d['hsv'] <= 1)).all()
        offs |= set(d['offs'].tolist())
        flips |= set(d['flips'].tolist())
        kept += int(aug.apply(x, t, v, d)[2].sum())
        with jax.default_matmul_precision('highest'):
            jkept += int(jaug(jnp.asarray(imgs), jnp.asarray(tgt),
                              jnp.asarray(valid),
                              jax.random.PRNGKey(seed))[2].sum())
    assert offs == {1, 2, 3} and flips == {False, True}
    n = 32 * 4 * int(valid.sum())
    assert abs(kept / n - jkept / n) < 0.05, (kept / n, jkept / n)
    assert 0.1 < kept / n < 0.9


def test_run_training_with_device_aug(tmp_path, monkeypatch):
    """``run_training(device_aug=True)`` on the CPU: the dataset no longer
    augments (one letterboxed image a sample), the batch goes through the
    device augmentation seeded ``seed * 100003 + ni`` at each of its 2
    steps, and the loss is finite. With ``bucket`` and ``name``, the loop
    copies its results and its checkpoint through gsutil's runner.
    ``--maxabsscaler`` and ``--rect`` are refused before the model loads,
    as the JAX loop's asserts refuse them."""
    from _torch_port import TOY_CFG
    from test_torch_augment import write_jpeg_set
    from yolo_tpu_torch.data import device_aug
    from yolo_tpu_torch.train import loop
    from yolo_tpu_torch.utils import gsutil
    lst = write_jpeg_set(str(tmp_path), n=8, nc=2, seed=4)
    val = tmp_path / 'val.txt'
    val.write_text(''.join(open(lst).readlines()[:2]))
    cfg = tmp_path / 'toy.cfg'
    cfg.write_text(TOY_CFG)
    (tmp_path / 'names').write_text('a\nb\n')
    data = tmp_path / 'set.data'
    data.write_text(f'classes=2\ntrain={lst}\nvalid={val}\n'
                    f'names={tmp_path}/names\n')
    seeds, datasets = [], []
    orig_call = device_aug.DeviceAugment.__call__
    orig_loader = loop.BatchLoader

    def spy_call(self, imgs, targets, valid, generator):
        seeds.append(generator.initial_seed())
        out = orig_call(self, imgs, targets, valid, generator)
        assert out[0].shape == imgs.shape and out[1].shape == targets.shape
        return out

    def spy_loader(ds, *a, **k):
        datasets.append(ds)
        return orig_loader(ds, *a, **k)
    monkeypatch.setattr(device_aug.DeviceAugment, '__call__', spy_call)
    monkeypatch.setattr(loop, 'BatchLoader', spy_loader)
    calls = []
    monkeypatch.setattr(gsutil, 'runner', lambda cmd: calls.append(cmd) or 0)
    monkeypatch.chdir(tmp_path)
    logs = []
    kw = dict(cfg=str(cfg), data=str(data), epochs=1, batch_size=4,
              img_size=(64, 64, 64), float_dtype='f32', device='cpu',
              device_aug=True, seed=5, bucket='bkt', name='x',
              results_file='resultsx.txt', log_fn=logs.append)
    res = loop.run_training(loop.TrainOptions(**kw))
    assert seeds == [5 * 100003, 5 * 100003 + 1]
    # --bucket: the results after the epoch, the checkpoints at the end
    assert calls == [
        ['gsutil', 'cp', 'resultsx.txt', 'gs://bkt/results/resultsx.txt'],
        ['gsutil', 'cp', os.path.join('weights', 'last.npz'),
         'gs://bkt/weights/last.npz']]
    assert not datasets[0].augment and not datasets[0].mosaic
    assert not any('non-finite' in m for m in logs)
    assert len(res) == 7 and np.isfinite(res).all()
    for bad in (dict(maxabsscaler=True), dict(rect=True)):
        with pytest.raises(ValueError, match='device-aug'):
            loop.run_training(loop.TrainOptions(**{**kw, **bad}))
