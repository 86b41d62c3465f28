"""Times the segment-mean kernels on one GPU at the graph sizes of the main
paths, beside their plain versions, one PyTorch library call for each
function and the memory bound.

    python3 urban_tpu_torch/kernel_bench.py [--root DIR] [--out FILE]

``--root`` imports ``urban_tpu_torch`` from another checkout (an older
commit unpacked with ``git archive``), so that two trees can be timed on one
card, in turns, with the same inputs; the forward rows' SHA-256 digests of
the mean and the counts then show whether the two trees give the same bits.
One JSON line per (shape, batch, kernel), then the same at the range
shapes (``RANGE_SHAPES``: the widths and graphs past the shipped
scenarios, the general plan among them), the general plan forced at the
HLG and Huizhou trainer graphs beside the plan chosen there, the
runtime-width instantiation beside the templated one at D 16 and 32, then
the forward kernel at every templated width on the trainer's graph, the
forward at each shape and batch with every launch plan that fits, the
backward at every templated width, then the backward at each shape with
every column tile that fits (``--measure_only``: the lines at SHAPES
alone; ``--range_only``: the range shapes and the two comparisons).
``chip_smoke.py`` takes its shapes, inputs, bounds and library calls from
here. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

B = 256
# (name, edges, nodes, width): the rollout bench's and the trainer's HLG
# graphs, a large graph at the widest supported width, the grid trainer's
# graph (its road stage, 2688 feature slots), the concept scenarios'
# trainer graph (4000 edge slots), the graph of the grid's two-phase
# road phase (the frozen plan of chip_smoke.py's seed-0 run: 1600 slots),
# the host environment's observation (grid.yaml's max_num_nodes and
# max_num_edges, the agent's policy step and update), the Huizhou
# trainer's graph (1472 feature slots) and the graph of the grid's
# two-phase land-use phase (cfg.train(), BOUNDARY segments kept: 1408
# slots), which is also the DHM trainer's (1408 feature slots)
SHAPES = (('rollout', 2304, 1088, 16), ('trainer', 3000, 1344, 16),
          ('large_graph', 8192, 4096, 64), ('grid_trainer', 3000, 2688, 16),
          ('concept', 4000, 1344, 16), ('grid_phase2', 3000, 1600, 16),
          ('host_obs', 3000, 1000, 16), ('huizhou_trainer', 3000, 1472, 16),
          ('grid_phase1', 3000, 1408, 16))
# the batches a shape is timed at, where not only B: the failure replay
# re-collects the HLG rollout at a quarter of the bench's batch; the HLG
# and the Huizhou parity recipes evaluate 64 envs; the host agent's update
# takes minibatches of B rows, its policy step one observation; a
# data-parallel rank of two holds about half of each B-row minibatch of
# the HLG trainer (its graph, not in SHAPES: chip_smoke.py checks it); the
# Huizhou trainer updates on minibatches of B rows and collects with its
# config's 192 envs, as the grid trainer collects; the concept recipe
# collects and updates at B and evaluates 64 envs; each phase of the
# grid's two-phase recipe updates at B, collects 192 envs and evaluates 64
# (the DHM recipe at grid_phase1's shape: B and 64)
BATCHES = {'rollout': (B, B // 4), 'trainer': (B, 64), 'host_obs': (B, 1),
           'dp_rank_update': (B // 2,), 'huizhou_trainer': (B, 192, 64),
           'grid_trainer': (B, 192), 'concept': (B, 64),
           'grid_phase1': (B, 192, 64), 'grid_phase2': (B, 192, 64),
           'trainer_d24': (B, 64), 'trainer_d128': (B, 64),
           'trainer_d6': (B, 64),
           'trainer_e40k_d24': (B, 64, 8, 1), 'large_e100k': (8, 1),
           'large_e100k_d24': (8, 1)}
DP_RANK_UPDATE = ('dp_rank_update', 3000, 1344, 16)
# the range of graphs and widths the port takes beyond the shipped
# scenarios (each at its BATCHES): the HLG trainer's graph at the widths
# 24 and 128 of gcn_node_dim (the runtime-width instantiation of the
# shared-memory plans) and at 6 (its scalar loads, and the backward's
# gather path with scalar loads), HLG's nodes with max_num_edges 40000 at width 24
# (the general plan: keys past 16 bits; its update, collect, eval and a
# single observation), and a community of 40,000 nodes and 100,000 edge
# slots (the general plan: a CSR past one CTA; the backward's gather path,
# at width 16 its own instantiation, at 24 the runtime-width one)
RANGE_SHAPES = (('trainer_d24', 3000, 1344, 24),
                ('trainer_d128', 3000, 1344, 128),
                ('trainer_d6', 3000, 1344, 6),
                ('trainer_e40k_d24', 40000, 1344, 24),
                ('large_e100k', 100000, 40000, 16),
                ('large_e100k_d24', 100000, 40000, 24))
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


# the __global__ functions the wrappers launch, once a call each
# (csrc/segment_mean.cu, csrc/segment_mean_backward.cu), and the general
# plan's seven (segment_mean_csr_*), each once a call
FORWARD_KERNEL, BACKWARD_KERNEL = ('segment_mean_kernel',
                                   'segment_mean_backward_kernel')
GENERAL_KERNELS, GENERAL_LAUNCHES = r'segment_mean_csr_\w+', 7


def forward_kernels(plan) -> Tuple[str, int]:
    """(name pattern, launches a call) of the forward's __global__
    functions under `plan`."""
    if getattr(plan, 'general', False):
        return GENERAL_KERNELS, GENERAL_LAUNCHES
    return FORWARD_KERNEL, 1


# the head of a profiler trace: the trace drops the first K device
# events of its window, K set by what the process ran before (0-1 in a
# fresh process, 6-7 after a data-parallel run, 62 or more late in
# chip_smoke.py) and not by time (a host pause of 20-50 ms before or
# after the window's first launch changes nothing: PERF.md §6), so
# LEAD_MARKERS marker launches come before the timed calls
LEAD_MARKERS = 256


def one_trace(fn, kernel, reps=20, lead=LEAD_MARKERS, settle_s=0.0):
    """One torch.profiler trace of reps calls of fn(), each of which
    launches the CUDA kernels whose names match `kernel` (a name or a
    pattern) a fixed number of times: first a marker kernel
    (an add on a one-element tensor), settle_s seconds of host pause,
    `lead` more markers, the calls, one marker more. Returns
    {'kernel_events': the events of `kernel` the trace holds,
    'device_ms': their summed durations over reps (a call's), 'by_kernel':
    the same split by the function's name (the general plan's seven),
    'lead_markers': the markers it holds before the first of them,
    'trail_marker': whether it holds the one after the last}."""
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, device='cuda')
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        marker.add_(1)
        torch.cuda.synchronize()
        time.sleep(settle_s)
        for _ in range(lead):
            marker.add_(1)
        for _ in range(reps):
            fn()
        marker.add_(1)
        torch.cuda.synchronize()
    name = re.compile(rf'\b{kernel}\b')
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = sorted(e.time_range.start for e in events if name.search(e.name))
    marks = [e.time_range.start for e in events if not name.search(e.name)]
    by_kernel = {}
    for e in events:
        found = name.search(e.name)
        if found:
            by_kernel[found.group(0)] = by_kernel.get(found.group(0), 0.0) \
                + e.time_range.elapsed_us() * 1e-3 / reps
    return {'kernel_events': len(ours),
            'device_ms': sum(by_kernel.values()), 'by_kernel': by_kernel,
            'lead_markers': sum(t < ours[0] for t in marks) if ours else 0,
            'trail_marker': bool(ours) and any(t > ours[-1] for t in marks)}


def trace_check(segment_ops, rng, dev, traces=8,
                heads=((0, 0.0), (0, 0.02), (64, 0.02)), reps=20):
    """`traces` profiler traces of each kernel at DP_RANK_UPDATE for each
    head of `heads` ((lead, settle_s) of one_trace), none retaken: one row
    a trace, to see when and where a trace loses kernel events."""
    shape, e, n, d = DP_RANK_UPDATE
    b = BATCHES[shape][0]
    edges, mask = random_graph(rng, b, e, n)
    h = torch.as_tensor(rng.normal(size=(b, e, d)), dtype=torch.float32)
    g = torch.as_tensor(rng.normal(size=(b, n, d)), dtype=torch.float32)
    h, g, edges, mask = (x.to(dev) for x in (h, g, edges, mask))
    counts = _counts(segment_ops, edges, mask, n)
    fns = {FORWARD_KERNEL: lambda: segment_ops.segment_mean_counts(
        h, edges, mask, n), BACKWARD_KERNEL: lambda:
        segment_ops.segment_mean_backward(g, counts, edges, mask)}
    rows = []
    for lead, settle_s in heads:
        for kernel, fn in fns.items():
            fn()
            for i in range(traces):
                rows.append({'shape': shape, 'B': b, 'kernel': kernel,
                             'lead': lead, 'settle_s': settle_s, 'trace': i,
                             'reps': reps,
                             **one_trace(fn, kernel, reps, lead, settle_s)})
    return rows


def device_trace(fn, kernel, reps=20, attempts=5, per_call=1):
    """(device ms per call of fn(), readings): the summed durations of
    the `kernel` launches of reps calls of fn() (per_call a call), from a
    torch.profiler trace (no host time). A trace that holds fewer than
    reps x per_call of them is taken again, up to `attempts` traces;
    readings holds every trace's one_trace dict, and the time is None when
    none was whole (never a partial sum)."""
    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(attempts):
        readings.append(one_trace(fn, kernel, reps))
        if readings[-1]['kernel_events'] == reps * per_call:
            return readings[-1]['device_ms'], readings
    return None, readings


def device_time_ms(fn, kernel, reps=20, per_call=1):
    """device_trace's time per call."""
    return device_trace(fn, kernel, reps, per_call=per_call)[0]


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


def digest(t: torch.Tensor) -> str:
    """SHA-256 of a tensor's bytes: equal digests from two trees are
    equal bits."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def forward_plan_of(segment_ops, b, n, e, d):
    """The forward's launch plan as a dict, where the tree has one (trees
    before forward_plan launched one CTA of 512 threads an element)."""
    plan = getattr(segment_ops, 'forward_plan', None)
    return plan(b, n, e, d)._asdict() if plan else None


def plans_under(segment_ops, limits) -> dict:
    """forward_plan at every shape and batch that measure times and
    backward_plan at every shape, on a card of `limits`
    (segment_ops.DeviceLimits), as tuples keyed 'shape:B'."""
    out = {}
    for name, e, n, d in SHAPES + (DP_RANK_UPDATE,):
        for b in BATCHES.get(name, (B,)):
            out[f'{name}:{b}'] = (
                tuple(segment_ops.forward_plan(b, n, e, d, limits)),
                tuple(segment_ops.backward_plan(n, d, limits)))
    return out


def measure(segment_ops, rng, dev, reps=20, shapes=SHAPES + (DP_RANK_UPDATE,)):
    """Every kernel of segment_ops at every shape of `shapes` (SHAPES and
    DP_RANK_UPDATE; range_measure: RANGE_SHAPES), at each of its BATCHES,
    on random bipartite graphs: error against the plain version, and the
    times of the kernel, the plain version and the library call, with the
    bound and the share of it the kernel's device time reaches; each
    forward row also carries the plan and the SHA-256 of its mean and
    counts (equal across trees where the bits are)."""
    # trees before the one forward kernel named the counts-returning
    # forward segment_mean_edge, and ran another kernel for segment_mean
    counts_fn = getattr(segment_ops, 'segment_mean_counts', None) or \
        segment_ops.segment_mean_edge
    rows = []
    for shape, e, n, d, b in ((*s, b) for s in shapes
                              for b in BATCHES.get(s[0], (B,))):
        edges, mask = random_graph(rng, b, e, n)
        h = torch.where(mask[..., None], torch.as_tensor(
            rng.normal(size=(b, e, d)), dtype=torch.float32), 0.0)
        g = torch.as_tensor(rng.normal(size=(b, n, d)), dtype=torch.float32)
        h, g, edges, mask = (x.to(dev) for x in (h, g, edges, mask))
        ref, counts = segment_ops.segment_mean_counts_ref(h, edges, mask, n)
        lib_fwd, lib_out = library_forward(h, edges, mask, n)
        fwd_bound = bound_ms(forward_bytes(edges, mask, n, d))
        plan = getattr(segment_ops, 'forward_plan', None)
        fwd_kernel = forward_kernels(plan(b, n, e, d) if plan else None)
        with torch.no_grad():
            cases = {
                'segment_mean': (
                    lambda: segment_ops.segment_mean(h, edges, mask, n),
                    fwd_kernel, ref, fwd_bound, lib_fwd, lib_out,
                    lambda: segment_ops.segment_mean_ref(h, edges, mask, n)),
                counts_fn.__name__: (
                    lambda: counts_fn(h, edges, mask, n)[0],
                    fwd_kernel, ref, fwd_bound, lib_fwd, lib_out,
                    lambda: segment_ops.segment_mean_counts_ref(
                        h, edges, mask, n)),
            }
            dref = segment_ops.segment_mean_backward_ref(g, counts, edges,
                                                         mask)
            lib_bwd, lib_dh = library_backward(g, counts, edges, mask)
            cases['segment_mean_backward'] = (
                lambda: segment_ops.segment_mean_backward(g, counts, edges,
                                                          mask),
                (BACKWARD_KERNEL, 1), dref,
                bound_ms(backward_bytes(edges, mask, counts, d)),
                lib_bwd, lib_dh,
                lambda: segment_ops.segment_mean_backward_ref(
                    g, counts, edges, mask))
            out, cnt = counts_fn(h, edges, mask, n)
            forward = {'plan': forward_plan_of(segment_ops, b, n, e, d),
                       'out_sha256': digest(out),
                       'counts_sha256': digest(cnt)}
            for name, (fn, kernel, want, bnd, lib, lib_res,
                       plain) in cases.items():
                got = fn()
                err = float((got - want).abs().max())
                lib_err = float((lib_res - want).abs().max())
                if not (err <= TOL and lib_err <= TOL):
                    raise AssertionError(f'{shape} {name}: error {err}, '
                                         f'library {lib_err} > {TOL}')
                device_ms, readings = device_trace(fn, kernel[0], reps,
                                                   per_call=kernel[1])
                rows.append({
                    'shape': shape, 'B': b, 'E': e, 'N': n, 'D': d,
                    'kernel': name, 'max_abs_err': err,
                    'equal_to_plain': bool(torch.equal(got, want)),
                    'library_max_abs_err': lib_err,
                    'ms': cuda_time_ms(fn, reps),
                    'device_ms': device_ms,
                    'plain_ms': cuda_time_ms(plain, reps),
                    'library_ms': cuda_time_ms(lib, reps),
                    'bound_ms': bnd,
                    'bound_share': bnd / device_ms if device_ms else None,
                    'by_kernel': (readings[-1]['by_kernel'] if device_ms
                                  and kernel[1] > 1 else None),
                    **(forward if kernel[0] != BACKWARD_KERNEL else {})})
    return rows


def range_measure(segment_ops, rng, dev, reps=20):
    """measure at RANGE_SHAPES (trees that take only the templated widths
    and the graphs of one CTA have nothing to time there)."""
    if getattr(segment_ops, 'general_plan', None) is None:
        return []
    return measure(segment_ops, rng, dev, reps, shapes=RANGE_SHAPES)


def _timed_plan(segment_ops, fn, plan, reps):
    """A plan's times: events, device, and the device time by kernel (of
    the whole trace)."""
    kernel, per_call = forward_kernels(plan)
    device_ms, readings = device_trace(fn, kernel, reps, per_call=per_call)
    return {'plan': plan._asdict(), 'ms': cuda_time_ms(fn, reps),
            'device_ms': device_ms,
            'by_kernel': readings[-1]['by_kernel'] if device_ms else None}


def plain_and_library_ms(segment_ops, h, edges, mask, n, reps=20):
    """The forward's plain version and its library call (library_forward)
    timed on the same inputs."""
    lib, _ = library_forward(h, edges, mask, n)
    return {'plain_ms': cuda_time_ms(
        lambda: segment_ops.segment_mean_counts_ref(h, edges, mask, n),
        reps), 'library_ms': cuda_time_ms(lib, reps)}


def general_vs_chosen(segment_ops, rng, dev, reps=20,
                      shapes=('trainer', 'huizhou_trainer')):
    """The general plan forced at the HLG and the Huizhou trainer's graphs
    (B 256) beside the plan forward_plan chooses there: their times, the
    bound, the plain version's and the library call's, and the SHA-256 of each plan's mean and counts, which must be
    equal (both add each node's rows in edge order and divide once)."""
    if getattr(segment_ops, 'general_plan', None) is None:
        return []
    rows = []
    for shape, e, n, d in (s for s in SHAPES if s[0] in shapes):
        edges, mask = random_graph(rng, B, e, n)
        h = torch.as_tensor(rng.normal(size=(B, e, d)), dtype=torch.float32)
        h, edges, mask = h.to(dev), edges.to(dev), mask.to(dev)
        bnd = bound_ms(forward_bytes(edges, mask, n, d))
        row = {'shape': f'{shape}_general_vs_chosen', 'B': B, 'E': e,
               'N': n, 'D': d, 'kernel': 'segment_mean', 'bound_ms': bnd,
               **plain_and_library_ms(segment_ops, h, edges, mask, n, reps)}
        for name, plan in (('chosen', segment_ops.forward_plan(B, n, e, d)),
                           ('general', segment_ops.general_plan())):
            def fn(plan=plan):
                return segment_ops.segment_mean_counts(h, edges, mask, n,
                                                       plan)
            out, cnt = fn()
            row[name] = {**_timed_plan(segment_ops, fn, plan, reps),
                         'out_sha256': digest(out),
                         'counts_sha256': digest(cnt)}
            row[name]['bound_share'] = (bnd / row[name]['device_ms']
                                        if row[name]['device_ms'] else None)
        row['same_bits'] = all(row['chosen'][k] == row['general'][k]
                               for k in ('out_sha256', 'counts_sha256'))
        rows.append(row)
    return rows


def any_width_vs_templated(segment_ops, rng, dev, reps=20,
                           widths=(16, 32), batches=(B, 64)):
    """At the trainer's graph, for D 16 and 32 at B 256 and 64: the plan
    forward_plan chooses with D's own instantiation against the same plan
    with the runtime-width one (any_width), their times beside the plain
    version's and the library call's, and whether they give the same
    bits."""
    if getattr(segment_ops, 'general_plan', None) is None:
        return []
    _, e, n, _ = SHAPES[1]
    rows = []
    for d in widths:
        for b in batches:
            edges, mask = random_graph(rng, b, e, n)
            h = torch.as_tensor(rng.normal(size=(b, e, d)),
                                dtype=torch.float32)
            h, edges, mask = h.to(dev), edges.to(dev), mask.to(dev)
            chosen = segment_ops.forward_plan(b, n, e, d)
            row = {'shape': 'trainer_any_width_vs_templated', 'B': b,
                   'E': e, 'N': n, 'D': d, 'kernel': 'segment_mean',
                   'bound_ms': bound_ms(forward_bytes(edges, mask, n, d)),
                   **plain_and_library_ms(segment_ops, h, edges, mask, n,
                                          reps)}
            outs = []
            for name, plan in (('templated', chosen),
                               ('any_width', chosen._replace(
                                   any_width=True))):
                def fn(plan=plan):
                    return segment_ops.segment_mean_counts(h, edges, mask,
                                                           n, plan)
                outs.append(fn())
                row[name] = _timed_plan(segment_ops, fn, plan, reps)
            row['same_bits'] = all(torch.equal(x, y)
                                   for x, y in zip(*outs))
            rows.append(row)
    return rows


def forward_plans(segment_ops, b, n, e, d):
    """Every launch plan of the forward kernel whose shared memory fits one
    CTA: each split at each block size reading h from global memory, and
    the staged plan (one CTA of 1024 threads an element)."""
    plans = [segment_ops.ForwardPlan(split, threads, False,
                                     segment_ops.forward_shared_bytes(
                                         n, e, d, split, threads, False))
             for split in segment_ops.FORWARD_SPLITS
             for threads in segment_ops.FORWARD_THREADS]
    plans.append(segment_ops.ForwardPlan(1, 1024, True,
                                         segment_ops.forward_shared_bytes(
                                             n, e, d, 1, 1024, True)))
    return [p for p in plans if p.shared_bytes
            + segment_ops.FORWARD_STATIC_BYTES
            <= segment_ops.SHARED_BYTES_PER_BLOCK]


def forward_plan_sweep(segment_ops, rng, dev, reps=20):
    """The forward kernel at every shape of SHAPES and each of its
    BATCHES with every launch plan that fits (forward_plans): what
    forward_plan's choice ('chosen') is worth against the others; each
    must give the chosen plan's bits. Trees without launch plans have
    nothing to sweep."""
    if getattr(segment_ops, 'ForwardPlan', None) is None:
        return []
    rows = []
    for shape, e, n, d, b in ((*s, b) for s in SHAPES
                              for b in BATCHES.get(s[0], (B,))):
        edges, mask = random_graph(rng, b, e, n)
        h = torch.as_tensor(rng.normal(size=(b, e, d)), dtype=torch.float32)
        h, edges, mask = h.to(dev), edges.to(dev), mask.to(dev)
        chosen = segment_ops.forward_plan(b, n, e, d)
        want = segment_ops.segment_mean_counts(h, edges, mask, n)
        bnd = bound_ms(forward_bytes(edges, mask, n, d))
        for plan in forward_plans(segment_ops, b, n, e, d):
            def fn(plan=plan):
                return segment_ops.segment_mean_counts(h, edges, mask, n,
                                                       plan)
            got = fn()
            device_ms = device_time_ms(fn, FORWARD_KERNEL, reps)
            rows.append({
                'shape': f'{shape}_forward_plan_sweep', 'B': b, 'E': e,
                'N': n, 'D': d, 'kernel': 'segment_mean',
                'plan': plan._asdict(), 'chosen': plan == chosen,
                'equal_to_chosen': bool(torch.equal(got[0], want[0])
                                        and torch.equal(got[1], want[1])),
                'ms': cuda_time_ms(fn, reps), 'device_ms': device_ms,
                'bound_ms': bnd,
                'bound_share': bnd / device_ms if device_ms else None})
    return rows


def width_sweep(segment_ops, rng, dev, reps=20):
    """The forward kernel at the trainer's graph (E=3000, N=1344) for every
    supported width: its time against the bytes, which grow with D, and
    the CSR build, which does not."""
    _, e, n, _ = SHAPES[1]
    edges, mask = random_graph(rng, B, e, n)
    edges, mask = edges.to(dev), mask.to(dev)
    rows = []
    for d in _templated_dims(segment_ops):
        h = torch.where(mask[..., None], torch.as_tensor(
            rng.normal(size=(B, e, d)), dtype=torch.float32,
            device=dev), 0.0)
        def fn():
            return segment_ops.segment_mean(h, edges, mask, n)
        rows.append({'shape': 'trainer_width_sweep', 'B': B, 'E': e, 'N': n,
                     'D': d, 'kernel': 'segment_mean',
                     'plan': forward_plan_of(segment_ops, B, n, e, d),
                     'ms': cuda_time_ms(fn, reps),
                     'device_ms': device_time_ms(fn, FORWARD_KERNEL, reps),
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
    for d in _templated_dims(segment_ops):
        g = torch.as_tensor(rng.normal(size=(B, n, d)), dtype=torch.float32,
                            device=dev)
        def fn():
            return segment_ops.segment_mean_backward(g, counts, edges, mask)
        rows.append({'shape': 'trainer_backward_width_sweep', 'B': B, 'E': e,
                     'N': n, 'D': d, 'kernel': 'segment_mean_backward',
                     'plan': plan(n, d)._asdict() if plan else None,
                     'ms': cuda_time_ms(fn, reps),
                     'device_ms': device_time_ms(fn, BACKWARD_KERNEL, reps),
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
                'device_ms': device_time_ms(fn, BACKWARD_KERNEL, reps),
                'bound_ms': bound_ms(backward_bytes(edges, mask, counts, d))})
    return rows


def _templated_dims(segment_ops):
    """The widths with their own instantiations (trees before any width
    was taken named them SUPPORTED_DIMS)."""
    return getattr(segment_ops, 'TEMPLATED_DIMS', None) or \
        segment_ops.SUPPORTED_DIMS


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
    ap.add_argument('--measure_only', action='store_true',
                    help='only the rows at SHAPES x BATCHES, no sweeps')
    ap.add_argument('--range_only', action='store_true',
                    help='only the rows at RANGE_SHAPES and the general-plan '
                    'and runtime-width comparisons')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('kernel_bench: no CUDA device')
    root = os.path.abspath(args.root or os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from urban_tpu_torch.ops import segment_ops
    segment_ops.build_libraries()
    dev = torch.device('cuda', 0)
    every = [measure, range_measure, general_vs_chosen,
             any_width_vs_templated, width_sweep, forward_plan_sweep,
             backward_width_sweep, backward_tile_sweep]
    parts = (every[:1] if args.measure_only else every[1:4]
             if args.range_only else every)
    # a generator a part, so that each part's inputs are the same in trees
    # and runs that skip another part
    rows = [r for part in parts for r in part(
        segment_ops, np.random.default_rng([args.seed, every.index(part)]),
        dev)]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader', '--id=0'],
                          capture_output=True, text=True).stdout.strip()
    lines = [json.dumps({'root': root, 'gpu': torch.cuda.get_device_name(0),
                         'card': card, **r}) for r in rows]
    print('\n'.join(lines), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'a') as f:
            f.write('\n'.join(lines) + '\n')


if __name__ == '__main__':
    main()
