#!/usr/bin/env python3
"""K1 (the port's NMS suppression kernel) on the card: its device time by
cluster size and batch, the plan's choice, and where one call's time goes.

    python3 scripts/k1_sweep.py [--phases] [--exchange] [--root DIR]
                                [--out FILE.json]

Default: for bs 1, 2, 4, 8, 16 and 64 at k 512 and 1024, on the seeded
heavy-overlap candidates of ``chip_smoke.py`` phase 3, every cluster size
4, 8 and 16 timed in two rounds of turns (``chip_smoke.device_ms``, the
device alone), each launch's ``keep`` held to the plain version, and the
cluster that ``suppress_plan`` picks there.

``--phases`` adds, at k=512, bs=8 and each cluster size, the time of each
phase: an instrumented copy of ``csrc/nms_suppress.cu`` (thread 0 of every
CTA stamps ``%globaltimer`` where the loads, the build, the first cluster
barrier, the sweeps and the merge end, and records ``%smid``) is built
with the library's nvcc flags into a temporary directory; it prints the
median of each phase over the CTAs, the span from the first CTA's start
to the last CTA's end, and the SMs the CTAs ran on, beside the device time
of one tiny elementwise kernel (the timer's floor).

``--exchange`` adds the same phases for a variant of the sweeps' exchange
(each keep word goes by ``st.async`` into the peers' buffers, completing
bytes on an ``mbarrier`` of each peer, which waits on its own mbarrier
instead of one cluster barrier a sweep; built from this source by the
substitutions in ``EXCHANGE``), beside the kernel as it is, on the
heavy-overlap set and on a 40-box chain at 1, 3 and 16 sweeps, each
launch's keep and merged held to the plain version.

``--root DIR`` times only K1 at k=512, bs=8, merge, on both of
``chip_smoke.py``'s timers with the wrapper's host time per call, for the
port of the checkout DIR (another commit unpacked with ``git archive``
into a git-ignored directory, say), so that two versions are timed by the
same code: run it for each, in turns, in one chip call.

Prints the card's name and power limit, and last one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (inputs and timers)

BATCHES = (1, 2, 4, 8, 16, 64)
KS = (512, 1024)
CLUSTERS = (4, 8, 16)
PHASES = ('load', 'build', 'first barrier', 'sweeps', 'merge', 'exit')
# the instrumented copy stamps before each anchor; stamp n ends phase n
STAMPS = (('  // The graph of the own columns:', 1),
          ('  // every CTA of the cluster has started', 2),
          ('  uint32_t keepw = lane < nw', 3),
          ('  // no store into a peer after this point', 4),
          ('  asm volatile("barrier.cluster.wait.aligned;', 5))
START = '  const uint8_t* const vd = valid + img * k;\n'
END = '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");\n'
SIGNATURE = 'int k, float iou_thres, int max_sweeps, int merge) {'
LAUNCH_ARGS = 'max_sweeps, merge);'


def _sub(text, old, new):
    if text.count(old) != 1:
        raise SystemExit(f'k1_sweep: not found once in the source: {old!r}')
    return text.replace(old, new)


def _stamp(n):
    return ('  if (threadIdx.x == 0) { unsigned long long t; asm volatile('
            '"mov.u64 %0, %%globaltimer;" : "=l"(t)); '
            f'stamps[blockIdx.x * 8 + {n}] = t; }}\n')


def instrumented_source(src):
    """The kernel source with the phase stamps, the SM id in slot 7, and a
    ``stamps`` pointer set by ``set_stamps``."""
    src = _sub(src, START, START + _stamp(0) + (
        '  if (threadIdx.x == 0) { unsigned s; asm volatile("mov.u32 %0, '
        '%%smid;" : "=r"(s)); stamps[blockIdx.x * 8 + 7] = s; }\n'))
    for anchor, n in STAMPS:
        src = _sub(src, anchor, _stamp(n) + anchor)
    src = _sub(src, END, END + _stamp(6))
    src = _sub(src, SIGNATURE, SIGNATURE[:-3]
               + ', unsigned long long* stamps) {')
    src = _sub(src, LAUNCH_ARGS, 'max_sweeps, merge, g_stamps);')
    src = _sub(src, 'namespace {\n',
               'namespace {\nunsigned long long* g_stamps;\n')
    return _sub(src, 'extern "C" {\n', 'extern "C" {\nvoid set_stamps(void* '
                'p) { g_stamps = static_cast<unsigned long long*>(p); }\n')


# the sweeps' exchange by st.async into the peers' buffers and an mbarrier
# per buffer (phase parity (s >> 1) & 1, 4 * nw bytes a phase), a trap
# after ~2 s of waiting; its 16 bytes of static shared memory lower the
# dynamic cap
EXCHANGE = (
    ('namespace {\n', 'namespace {\n' + r'''
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* m) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(m)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* m, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(m)), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* m, unsigned parity) {
  unsigned ok;
  asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster"
               ".shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
               : "=r"(ok) : "r"(smem_u32(m)), "r"(parity) : "memory");
  return ok != 0;
}
__device__ __forceinline__ uint32_t mapa(uint32_t a, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async(uint32_t a, uint32_t v, uint32_t m) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
               "[%0], %1, [%2];" :: "r"(a), "r"(v), "r"(m) : "memory");
}
'''),
    ('      kSmemLimit);', '      kSmemLimit - 1024);'),
    (START, START + '''  __shared__ uint64_t s_mbar[2];
  if (tid == 0) {
    mbar_init(&s_mbar[0]);
    mbar_init(&s_mbar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
'''),
    ('    const int nxt = buf ^ 1;\n', '''    const int nxt = buf ^ 1;
    if (tid == 0) mbar_expect(&s_mbar[nxt], 4 * nw);
'''),
    ('        *cluster.map_shared_rank(s_keep + nxt * nw + cw, lane) = word;\n',
     '''        st_async(mapa(smem_u32(s_keep + nxt * nw + cw), lane), word,
                 mapa(smem_u32(&s_mbar[nxt]), lane));
'''),
    ('    cluster.sync();\n    // the new vector into registers', '''    {
      const long long t0 = clock64();
      while (!mbar_try_wait(&s_mbar[nxt], (s >> 1) & 1)) {
        if (clock64() - t0 > 4000000000LL) __trap();
      }
    }
    // the new vector into registers'''),
)


def build_instrumented(tmp, exchange=False):
    from yolo_tpu_torch import _build
    with open(os.path.join(_build.CSRC_DIR, 'nms_suppress.cu')) as f:
        src = f.read()
    if exchange:
        for old, new in EXCHANGE:
            src = _sub(src, old, new)
    src = instrumented_source(src)
    name = 'k1_exchange' if exchange else 'k1_phases'
    cu = os.path.join(tmp, name + '.cu')
    so = os.path.join(tmp, name + '.so')
    with open(cu, 'w') as f:
        f.write(src)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-shared',
                           '-o', so, cu], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f'k1_sweep: nvcc failed\n{proc.stdout}{proc.stderr}')
    lib = ctypes.CDLL(so)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nms_suppress_launch.argtypes = [p, p, p, p, p, p, i, i, f, i, i, i,
                                        i, p]
    lib.set_stamps.argtypes = [p]
    return lib


def stamped_run(lib, dev, boxes, scores, valid, cluster, sweeps=16):
    """Device time and per-phase medians of one instrumented launch
    configuration; checks keep and merged against the plain version."""
    from yolo_tpu_torch.ops.nms_suppress import suppress_reference
    bs, k = valid.shape
    keep, merged = torch.empty_like(valid), torch.empty_like(boxes)
    stamps = torch.zeros((bs * cluster, 8), dtype=torch.int64, device=dev)
    lib.set_stamps(stamps.data_ptr())
    run = lambda: lib.nms_suppress_launch(
        boxes.data_ptr(), boxes.data_ptr(), scores.data_ptr(),
        valid.data_ptr(), keep.data_ptr(), merged.data_ptr(), bs, k, 0.6,
        sweeps, 1, cluster, dev.index,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if run() != 0:
        raise SystemExit('k1_sweep: the instrumented launch was refused')
    torch.cuda.synchronize()
    ref = suppress_reference(boxes, boxes, scores, valid, iou_thres=0.6,
                             max_sweeps=sweeps)
    m = ref[0][..., None]
    if not (torch.equal(keep, ref[0]) and torch.allclose(
            torch.where(m, merged, 0.0), torch.where(m, ref[1], 0.0),
            **cs.KERNEL_TOL)):
        raise SystemExit(f'k1_sweep: the instrumented kernel disagrees with '
                         f'the plain version (cluster {cluster})')
    ms = cs.device_ms(run)
    st = stamps.cpu().numpy()
    t, sm = st[:, :7], st[:, 7]
    med = {n: float(np.median(np.diff(t, axis=1)[:, j])) / 1e3
           for j, n in enumerate(PHASES)}
    return dict(device_ms=ms, span_us=float(t[:, 6].max() - t[:, 0].min())
                / 1e3, phases_us=med, sms=len(set(sm.tolist())),
                ctas_per_sm=int(np.bincount(sm).max()))


def show(what, r):
    print(f'  {what}: device {r["device_ms"]:.4f} ms, span {r["span_us"]:.2f}'
          f' us on {r["sms"]} SMs (at most {r["ctas_per_sm"]} CTAs an SM); '
          'median us: ' + ', '.join(f'{n} {v:.2f}'
                                    for n, v in r['phases_us'].items()))


def phases(dev):
    """Per-phase medians over the CTAs at k=512, bs=8, each cluster size."""
    tiny = torch.zeros(8, device=dev)
    floor = cs.device_ms(lambda: tiny.add_(0))
    print(f'  timer floor (device_ms of one tiny elementwise kernel): '
          f'{floor:.4f} ms')
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build_instrumented(tmp)
        args = cs.candidates(np.random.default_rng(0), cs.BS, 512, dev)
        for c in CLUSTERS:
            out[c] = stamped_run(lib, dev, *args, c)
            show(f'cluster {c}', out[c])
    return dict(timer_floor_ms=floor, clusters=out)


def exchange(dev):
    """The kernel against its st.async + mbarrier exchange, in turns."""
    cases = (('heavy overlap', 0, 16), ('chain of 40, 1 sweep', 40, 1),
             ('chain of 40, 3 sweeps', 40, 3),
             ('chain of 40, 16 sweeps', 40, 16))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = {'cluster barrier': build_instrumented(tmp),
                'st.async + mbarrier': build_instrumented(tmp, True)}
        for what, chain, sweeps in cases:
            args = cs.candidates(np.random.default_rng(7), cs.BS, 512, dev,
                                 chain)
            for name in (*libs, *reversed(libs)):
                for c in (8, 16):
                    r = stamped_run(libs[name], dev, *args, c, sweeps)
                    out.setdefault(f'{what}, {name}, cluster {c}', []).append(r)
                    show(f'{what}, {name}, cluster {c}', r)
    return out


def clusters(dev):
    """Device time of every cluster size by batch and k, the plan's pick."""
    from yolo_tpu_torch.ops import nms_suppress as K1
    rows = []
    for bs in BATCHES:
        for k in KS:
            boxes, scores, valid = cs.candidates(np.random.default_rng(bs),
                                                 bs, k, dev)
            args = (boxes, boxes, scores, valid)
            ref = K1.suppress_reference(*args, iou_thres=0.6)[0]
            out = (torch.empty_like(valid), torch.empty_like(boxes))
            times = {c: [] for c in CLUSTERS}
            for _ in range(2):
                for c in CLUSTERS:
                    launch = lambda: K1._launch(*args, *out, 0.6, 16, True, c)
                    launch()
                    torch.cuda.synchronize()
                    if not torch.equal(out[0], ref):
                        raise SystemExit(f'k1_sweep: keep differs at bs={bs} '
                                         f'k={k} cluster {c}')
                    times[c].append(cs.device_ms(launch, iters=30))
            plan = K1.device_plan(bs, k, dev.index)
            wide = K1.max_clusters(dev.index, k)
            med = {c: statistics.median(v) for c, v in times.items()}
            rows.append(dict(bs=bs, k=k, device_ms=med, plan=plan.cluster,
                             wide=wide))
            best = min(med, key=med.get)
            print(f'  bs={bs} k={k}: ' + ', '.join(
                f'cluster {c} {t:.4f} ms' for c, t in med.items())
                + f'; plan {plan.cluster} (the card holds {wide} clusters '
                  f'of 16), fastest {best}')
    return rows


def timers(dev):
    """K1 at k=512, bs=8, merge, through ``suppress`` of the imported port:
    caller's wait, device alone, host time per call."""
    from yolo_tpu_torch.ops.nms_suppress import suppress
    boxes, scores, valid = cs.candidates(np.random.default_rng(0), cs.BS,
                                         512, dev)
    fn = lambda: suppress(boxes, boxes, scores, valid, iou_thres=0.6)
    res = dict(ms=cs.cuda_ms(fn), device_ms=cs.device_ms(fn),
               host_us=cs.host_us(fn))
    print(f'  k=512 bs={cs.BS} merge: {res["ms"]:.4f} ms by the caller\'s '
          f'wait, {res["device_ms"]:.4f} ms on the device, host '
          f'{res["host_us"]:.1f} us per call')
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--phases', action='store_true',
                    help='also time each phase of one call')
    ap.add_argument('--exchange', action='store_true',
                    help='also time the st.async + mbarrier exchange')
    ap.add_argument('--root', help='time only K1 of the port in this '
                    'checkout, on both timers')
    ap.add_argument('--out', help='write every number to this JSON file')
    a = ap.parse_args()
    card = cs.phase_device()
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    if a.root:
        sys.path.insert(0, os.path.abspath(a.root))
        import yolo_tpu_torch
        print(f'  port: {os.path.dirname(yolo_tpu_torch.__file__)}')
        result = dict(root=a.root, **timers(dev))
    else:
        result = dict(timers=timers(dev), clusters=clusters(dev))
        if a.phases:
            result['phases'] = phases(dev)
        if a.exchange:
            result['exchange'] = exchange(dev)
    result['card'] = card
    if a.out:
        with open(a.out, 'w') as f:
            json.dump(result, f, indent=1)
    print(card)
    print(json.dumps(result))


if __name__ == '__main__':
    main()
