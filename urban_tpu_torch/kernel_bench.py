"""Times the segment-mean kernels on one GPU at the graph sizes of the main
paths, beside their plain versions, one PyTorch library call for each
function and the memory bound.

    python3 urban_tpu_torch/kernel_bench.py [--root DIR] [--out FILE]

``--root`` imports ``urban_tpu_torch`` from another checkout (an older
commit unpacked with ``git archive``), so that two trees can be timed on one
card, in turns, with the same inputs. One JSON line per (shape, kernel),
then the forward and the backward kernel at every width on the trainer's
graph, then the backward at each shape with every column tile that fits.
``chip_smoke.py`` takes its shapes, inputs, bounds and library calls from
here. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

B = 256
# (name, edges, nodes, width): the rollout bench's and the trainer's HLG
# graphs, and a large graph at the widest supported width
SHAPES = (('rollout', 2304, 1088, 16), ('trainer', 3000, 1344, 16),
          ('large_graph', 8192, 4096, 64))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
TOL = 1e-5   # kernel or library call vs plain version: f32 sums, other order


def random_graph(rng, batch, n_edges, n_nodes):
    """Bipartite endpoints (the domain's block x intersection graphs) as
    int32, and a mask with 30% of the edges masked out."""
    half = n_nodes // 2
    edges = np.concatenate([rng.integers(0, half, (batch, n_edges, 1)),
                            rng.integers(half, n_nodes, (batch, n_edges, 1))],
                           -1)
    return (torch.as_tensor(edges, dtype=torch.int32),
            torch.as_tensor(rng.random((batch, n_edges)) >= 0.3))


def cuda_time_ms(fn, reps=20):
    """CUDA-event time of reps back-to-back calls of fn() over reps, after
    a warm-up: the card's time per call wherever the host enqueues faster
    than the card runs, the host's otherwise."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_time_ms(fn, reps=20):
    """Device time per call of fn(): the summed durations of the kernels
    its reps calls ran, from a torch.profiler trace (no host time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us * 1e-3 / reps


def _keep(edges, mask, num_nodes):
    """(B, E, 2) bool: unmasked endpoints inside [0, num_nodes)."""
    return mask[..., None] & (edges >= 0) & (edges < num_nodes)


def forward_bytes(edges, mask, num_nodes, width) -> int:
    """Bytes the segment mean must move: the endpoints and the mask once,
    the row of h of every edge with a kept endpoint once, the mean and the
    counts once."""
    b, e = mask.shape
    rows = int(_keep(edges, mask, num_nodes).any(-1).sum())
    return b * e * 9 + rows * width * 4 + b * num_nodes * (width + 1) * 4


def backward_bytes(edges, mask, counts, width) -> int:
    """Bytes the segment mean's gradient must move: the endpoints, the
    mask and the counts once, the gradient row of every node with a
    nonzero count once, and the (B, E, D) gradient once."""
    b, e = mask.shape
    rows = int((counts > 0).sum())
    return (b * e * 9 + counts.numel() * 4 + rows * width * 4
            + b * e * width * 4)


def bound_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def _flat_index(edges, mask, num_nodes):
    """(B, E, 2) int64 rows of a (B * N + 1)-row table, the last row a sink
    for masked or out-of-range endpoints."""
    b = mask.shape[0]
    base = (torch.arange(b, device=edges.device) * num_nodes)[:, None, None]
    return torch.where(_keep(edges, mask, num_nodes), edges.long() + base,
                       b * num_nodes)


def library_forward(h, edges, mask, num_nodes
                    ) -> Tuple[Callable[[], torch.Tensor], torch.Tensor]:
    """index_reduce_ 'mean' of both endpoints' copies of h into a zeroed
    sink-padded table, with index and source made here, outside the timed
    call. Returns (call, (B, N, D) mean)."""
    b, e, d = h.shape
    idx = _flat_index(edges, mask, num_nodes).permute(2, 0, 1).reshape(-1)
    src = h.reshape(1, b * e, d).expand(2, -1, -1).reshape(2 * b * e, d)
    table = torch.zeros(b * num_nodes + 1, d, device=h.device)

    def call():
        return table.index_reduce_(0, idx, src, 'mean', include_self=False)
    return call, call()[:-1].reshape(b, num_nodes, d)


def library_backward(grad, counts, edges, mask
                     ) -> Tuple[Callable[[], torch.Tensor], torch.Tensor]:
    """embedding_bag 'sum' of the two endpoints' rows of
    grad / (counts + 1e-6) with a zero sink row, made here, outside the
    timed call. Returns (call, (B, E, D) gradient)."""
    b, n, d = grad.shape
    e = mask.shape[1]
    scaled = torch.cat([(grad / (counts[..., None] + 1e-6)).reshape(b * n, d),
                        grad.new_zeros(1, d)])
    idx = _flat_index(edges, mask, n).reshape(b * e, 2)

    def call():
        return F.embedding_bag(idx, scaled, mode='sum')
    return call, call().reshape(b, e, d)


def measure(segment_ops, rng, dev, reps=20):
    """Every kernel of segment_ops at every shape on random bipartite
    graphs: error against the plain version, and the times of the kernel,
    the plain version and the library call, with the bound."""
    # trees before the one forward kernel named the counts-returning
    # forward segment_mean_edge, and ran another kernel for segment_mean
    counts_fn = getattr(segment_ops, 'segment_mean_counts', None) or \
        segment_ops.segment_mean_edge
    rows = []
    for shape, e, n, d in SHAPES:
        edges, mask = random_graph(rng, B, e, n)
        h = torch.where(mask[..., None], torch.as_tensor(
            rng.normal(size=(B, e, d)), dtype=torch.float32), 0.0)
        g = torch.as_tensor(rng.normal(size=(B, n, d)), dtype=torch.float32)
        h, g, edges, mask = (x.to(dev) for x in (h, g, edges, mask))
        ref, counts = segment_ops.segment_mean_counts_ref(h, edges, mask, n)
        lib_fwd, lib_out = library_forward(h, edges, mask, n)
        fwd_bound = bound_ms(forward_bytes(edges, mask, n, d))
        with torch.no_grad():
            cases = {
                'segment_mean': (
                    lambda: segment_ops.segment_mean(h, edges, mask, n),
                    ref, fwd_bound, lib_fwd, lib_out,
                    lambda: segment_ops.segment_mean_ref(h, edges, mask, n)),
                counts_fn.__name__: (
                    lambda: counts_fn(h, edges, mask, n)[0],
                    ref, fwd_bound, lib_fwd, lib_out,
                    lambda: segment_ops.segment_mean_counts_ref(
                        h, edges, mask, n)),
            }
            dref = segment_ops.segment_mean_backward_ref(g, counts, edges,
                                                         mask)
            lib_bwd, lib_dh = library_backward(g, counts, edges, mask)
            cases['segment_mean_backward'] = (
                lambda: segment_ops.segment_mean_backward(g, counts, edges,
                                                          mask),
                dref, bound_ms(backward_bytes(edges, mask, counts, d)),
                lib_bwd, lib_dh,
                lambda: segment_ops.segment_mean_backward_ref(
                    g, counts, edges, mask))
            for name, (fn, want, bnd, lib, lib_res, plain) in cases.items():
                got = fn()
                err = float((got - want).abs().max())
                lib_err = float((lib_res - want).abs().max())
                if not (err <= TOL and lib_err <= TOL):
                    raise AssertionError(f'{shape} {name}: error {err}, '
                                         f'library {lib_err} > {TOL}')
                rows.append({
                    'shape': shape, 'B': B, 'E': e, 'N': n, 'D': d,
                    'kernel': name, 'max_abs_err': err,
                    'equal_to_plain': bool(torch.equal(got, want)),
                    'library_max_abs_err': lib_err,
                    'ms': cuda_time_ms(fn, reps),
                    'device_ms': device_time_ms(fn, reps),
                    'plain_ms': cuda_time_ms(plain, reps),
                    'library_ms': cuda_time_ms(lib, reps),
                    'bound_ms': bnd})
    return rows


def width_sweep(segment_ops, rng, dev, reps=20):
    """The forward kernel at the trainer's graph (E=3000, N=1344) for every
    supported width: its time against the bytes, which grow with D, and
    the CSR build, which does not."""
    _, e, n, _ = SHAPES[1]
    edges, mask = random_graph(rng, B, e, n)
    edges, mask = edges.to(dev), mask.to(dev)
    rows = []
    for d in segment_ops.SUPPORTED_DIMS:
        h = torch.where(mask[..., None], torch.as_tensor(
            rng.normal(size=(B, e, d)), dtype=torch.float32,
            device=dev), 0.0)
        def fn():
            return segment_ops.segment_mean(h, edges, mask, n)
        rows.append({'shape': 'trainer_width_sweep', 'B': B, 'E': e, 'N': n,
                     'D': d, 'kernel': 'segment_mean',
                     'ms': cuda_time_ms(fn, reps),
                     'device_ms': device_time_ms(fn, reps),
                     'bound_ms': bound_ms(forward_bytes(edges, mask, n, d))})
    return rows


def backward_width_sweep(segment_ops, rng, dev, reps=20):
    """The backward kernel at the trainer's graph for every supported
    width: its time against the bytes, most of which (dh and the rows of
    g) grow with D, and the endpoints and the mask, which do not. Records
    the launch plan where the tree has one (trees before it had none)."""
    _, e, n, _ = SHAPES[1]
    edges, mask = random_graph(rng, B, e, n)
    edges, mask = edges.to(dev), mask.to(dev)
    counts = _counts(segment_ops, edges, mask, n)
    plan = getattr(segment_ops, 'backward_plan', None)
    rows = []
    for d in segment_ops.SUPPORTED_DIMS:
        g = torch.as_tensor(rng.normal(size=(B, n, d)), dtype=torch.float32,
                            device=dev)
        def fn():
            return segment_ops.segment_mean_backward(g, counts, edges, mask)
        rows.append({'shape': 'trainer_backward_width_sweep', 'B': B, 'E': e,
                     'N': n, 'D': d, 'kernel': 'segment_mean_backward',
                     'plan': plan(n, d)._asdict() if plan else None,
                     'ms': cuda_time_ms(fn, reps),
                     'device_ms': device_time_ms(fn, reps),
                     'bound_ms': bound_ms(backward_bytes(edges, mask, counts,
                                                         d))})
    return rows


def backward_tile_sweep(segment_ops, rng, dev, reps=20):
    """The backward kernel at every shape of SHAPES with each column tile
    that fits one block's shared memory, and with the gather path, each at
    512 and 1024 threads a block: what backward_plan's choice ('chosen') is
    worth against the others. Trees without launch plans have nothing to
    sweep."""
    plan_type = getattr(segment_ops, 'BackwardPlan', None)
    if plan_type is None:
        return []
    rows = []
    for shape, e, n, d in SHAPES:
        edges, mask = random_graph(rng, B, e, n)
        edges, mask = edges.to(dev), mask.to(dev)
        counts = _counts(segment_ops, edges, mask, n)
        g = torch.as_tensor(rng.normal(size=(B, n, d)), dtype=torch.float32,
                            device=dev)
        want = segment_ops.segment_mean_backward_ref(g, counts, edges, mask)
        tiles = [(t, n * t * 4) for t in (64, 32, 16, 8, 4)
                 if t <= d and d % t == 0
                 and n * t * 4 <= segment_ops.SHARED_BYTES_PER_BLOCK]
        plans = [plan_type(t, size, threads)
                 for t, size in tiles + [(d, 0)] for threads in (512, 1024)]
        for plan in plans:
            def fn(plan=plan):
                return segment_ops.segment_mean_backward(g, counts, edges,
                                                         mask, plan)
            rows.append({
                'shape': f'{shape}_backward_tile_sweep', 'B': B, 'E': e,
                'N': n, 'D': d, 'kernel': 'segment_mean_backward',
                'plan': plan._asdict(),
                'chosen': plan == segment_ops.backward_plan(n, d),
                'equal_to_plain': bool(torch.equal(fn(), want)),
                'ms': cuda_time_ms(fn, reps),
                'device_ms': device_time_ms(fn, reps),
                'bound_ms': bound_ms(backward_bytes(edges, mask, counts, d))})
    return rows


def _counts(segment_ops, edges, mask, num_nodes):
    """(B, N) counts of a graph, from the plain forward."""
    b, e = mask.shape
    return segment_ops.segment_mean_counts_ref(
        torch.zeros(b, e, 8, device=mask.device), edges, mask, num_nodes)[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--root', default=None,
                    help='checkout whose urban_tpu_torch is timed')
    ap.add_argument('--out', default=None, help='also write the lines here')
    ap.add_argument('--seed', type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('kernel_bench: no CUDA device')
    root = os.path.abspath(args.root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from urban_tpu_torch.ops import segment_ops
    segment_ops.build_libraries()
    dev = torch.device('cuda', 0)
    rng = np.random.default_rng(args.seed)
    rows = (measure(segment_ops, rng, dev) + width_sweep(segment_ops, rng, dev)
            + backward_width_sweep(segment_ops, rng, dev)
            + backward_tile_sweep(segment_ops, rng, dev))
    lines = [json.dumps({'root': root, 'gpu': torch.cuda.get_device_name(0),
                         **r}) for r in rows]
    print('\n'.join(lines), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'a') as f:
            f.write('\n'.join(lines) + '\n')


if __name__ == '__main__':
    main()
