"""The port's segment mean (urban_tpu_torch.ops.segment_ops) against the JAX
package's XLA scatter and its two Pallas kernels (interpret mode), the
one-hot kernel and the per-edge kernel, which the port's one forward
kernel replaces.

Same inputs, made with numpy from a seed, go to both packages. Tolerance
1e-5 absolute: f32 sums of a few O(1) terms, taken in another order. The
summation order the kernel keeps, each node's rows added in edge order, is
pinned bit for bit on the plain version.

JAX is imported inside the tests that use it, so that the card-only test
collects on a machine without JAX:
    python -m pytest tests/test_torch_segment_ops.py -m gpu --noconftest
"""
import contextlib
import types

import numpy as np
import pytest
import torch

from urban_tpu_torch.ops import segment_ops

torch.set_num_threads(1)

ATOL = 1e-5


def _graph(case, B=3, E=96, N=40, D=8, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, E, D)).astype(np.float32)
    # domain graphs are bipartite (block, intersection)
    e0 = rng.integers(0, N // 2, size=(B, E, 1))
    e1 = rng.integers(N // 2, N, size=(B, E, 1))
    edges = np.concatenate([e0, e1], axis=-1).astype(np.int32)
    mask = rng.random((B, E)) < 0.7
    if case == 'masked_sentinel':
        # dead edge slots point both endpoints at the pad node, as build_obs
        tail = E // 3
        edges[:, -tail:] = N - 1
        mask[:, -tail:] = False
    elif case == 'self_loop':
        edges[:, :5, 1] = edges[:, :5, 0]
        mask[:, :5] = True
    h = np.where(mask[..., None], h, 0.0).astype(np.float32)
    return h, edges, mask, N


CASES = ['bipartite', 'masked_sentinel', 'self_loop']


@pytest.mark.parametrize('case,kernel', [
    *(pytest.param(c, 'onehot', id=c) for c in CASES),
    *(pytest.param(c, 'per_edge', id=f'per_edge-{c}') for c in CASES)])
def test_ref_matches_xla_and_pallas(case, kernel):
    import jax.numpy as jnp
    from urban_tpu.ops.pallas import segment_ops as jseg
    h, edges, mask, N = _graph(case)
    out = segment_ops.segment_mean_ref(torch.as_tensor(h),
                                       torch.as_tensor(edges),
                                       torch.as_tensor(mask), N).numpy()
    xla = np.asarray(jseg.segment_mean_xla(jnp.asarray(h), jnp.asarray(edges),
                                           jnp.asarray(mask), N))
    pallas_fn = {'onehot': jseg.segment_mean_onehot_pallas,
                 'per_edge': jseg.segment_mean_pallas}[kernel]
    pallas = np.asarray(pallas_fn(jnp.asarray(h), jnp.asarray(edges),
                                  jnp.asarray(mask), N, interpret=True))
    np.testing.assert_allclose(out, xla, rtol=0, atol=ATOL)
    np.testing.assert_allclose(out, pallas, rtol=0, atol=ATOL)


def test_masked_edges_ignore_their_rows():
    """A masked edge adds nothing even when its row is not zeroed (the
    Pallas kernel routes it to a dropped sink row)."""
    h, edges, mask, N = _graph('bipartite', seed=1)
    noisy = np.where(mask[..., None], h, 123.0).astype(np.float32)
    a = segment_ops.segment_mean_ref(torch.as_tensor(h),
                                     torch.as_tensor(edges),
                                     torch.as_tensor(mask), N)
    b = segment_ops.segment_mean_ref(torch.as_tensor(noisy),
                                     torch.as_tensor(edges),
                                     torch.as_tensor(mask), N)
    assert torch.equal(a, b)


def test_wrapper_on_cpu_runs_plain_version():
    h, edges, mask, N = _graph('bipartite', seed=2)
    before = dict(segment_ops.launches)
    out = segment_ops.segment_mean(torch.as_tensor(h), torch.as_tensor(edges),
                                   torch.as_tensor(mask), N)
    ref = segment_ops.segment_mean_ref(torch.as_tensor(h),
                                       torch.as_tensor(edges),
                                       torch.as_tensor(mask), N)
    assert torch.equal(out, ref)
    assert segment_ops.launches == before


def _bad_inputs():
    h, edges, mask, N = _graph('bipartite')
    h, edges, mask = (torch.as_tensor(h), torch.as_tensor(edges),
                      torch.as_tensor(mask))
    return {
        'h_float64': (h.double(), edges, mask, N, TypeError),
        'edges_int64': (h, edges.long(), mask, N, TypeError),
        'mask_not_bool': (h, edges, mask.int(), N, TypeError),
        'edges_shape': (h, edges[:, :-1], mask, N, ValueError),
        'mask_shape': (h, edges, mask[:, :-1], N, ValueError),
        'h_rank': (h[0], edges, mask, N, ValueError),
        # any width D >= 1 is taken; a width of 0 is not
        'unsupported_width': (h[..., :0].contiguous(), edges, mask, N,
                              ValueError),
        'not_contiguous': (h.transpose(0, 1).contiguous().transpose(0, 1),
                           edges, mask, N, ValueError),
        'no_nodes': (h, edges, mask, 0, ValueError),
    }


@pytest.mark.parametrize('name', sorted(_bad_inputs()))
def test_wrapper_rejects_bad_inputs(name):
    h, edges, mask, n, exc = _bad_inputs()[name]
    with pytest.raises(exc):
        segment_ops.segment_mean(h, edges, mask, n)


def _edge_order_mean(h, edges, mask, N):
    """Each node's rows added in edge order in f32, over count + 1e-6."""
    B, E, D = h.shape
    s = np.zeros((B, N, D), np.float32)
    c = np.zeros((B, N), np.float32)
    for b in range(B):
        for e in np.flatnonzero(mask[b]):
            for n in edges[b, e]:
                if 0 <= n < N:
                    s[b, n] += h[b, e]
                    c[b, n] += 1
    return s / (c[..., None] + np.float32(1e-6)), c


def test_plain_version_sums_in_edge_order():
    """On a bipartite graph each node is an endpoint of one kind only, so
    the plain version's two index_add_ passes add its rows in edge order:
    the order the forward kernel keeps, and so the bits it must give."""
    h, edges, mask, N = _graph('bipartite', B=2, E=3000, N=1344, D=16,
                               seed=4)
    out, counts = segment_ops.segment_mean_counts_ref(
        torch.as_tensor(h), torch.as_tensor(edges), torch.as_tensor(mask), N)
    want, want_counts = _edge_order_mean(h, edges, mask, N)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize('case', CASES)
def test_counts_match_pallas(case):
    """The per-node counts against the interpreted Pallas per-edge kernel:
    with every row of h equal to 1 it returns count / (count + 1e-6)."""
    import jax.numpy as jnp
    from urban_tpu.ops.pallas import segment_ops as jseg
    h, edges, mask, N = _graph(case, seed=5)
    ones = np.ones_like(h)
    _, counts = segment_ops.segment_mean_counts_ref(
        torch.as_tensor(ones), torch.as_tensor(edges), torch.as_tensor(mask),
        N)
    pallas = np.asarray(jseg.segment_mean_pallas(
        jnp.asarray(ones), jnp.asarray(edges), jnp.asarray(mask), N,
        interpret=True))
    want = (counts / (counts + 1e-6)).numpy()
    np.testing.assert_array_equal(pallas, np.broadcast_to(
        want[..., None], pallas.shape))


@pytest.mark.gpu
def test_kernel_on_card():
    """Forward kernel at the trainer's graph size (E=3000, N=1344, D=16) on
    a bipartite graph, at B = 8, 1 and 64 with forward_plan's plan and at
    B = 8 also with one CTA an element, with a cluster of 8 and staged in
    shared memory: the CPU plain version's bits and counts, within ATOL of
    the plain version on the card, bitwise repeatable, and the kernel the
    no-gradient segment_mean runs (skips without a CUDA device;
    chip_smoke.py runs the same checks at every shape and batch of
    kernel_bench)."""
    if not torch.cuda.is_available():
        pytest.skip('requires a CUDA device')
    dev = torch.device('cuda')
    E, N, D = 3000, 1344, 16
    runs = [(b, None) for b in (8, 1, 64)] + [
        (8, segment_ops.ForwardPlan(s, t, g, segment_ops.forward_shared_bytes(
            N, E, D, s, t, g))) for s, t, g in ((1, 512, False),
                                                (8, 1024, False),
                                                (1, 1024, True))]
    kinds = set()
    for B, plan in runs:
        h, edges, mask, N = _graph('masked_sentinel', B=B, E=E, N=N, D=D)
        cpu = (torch.as_tensor(h), torch.as_tensor(edges),
               torch.as_tensor(mask))
        args = tuple(x.to(dev) for x in cpu)
        p = plan or segment_ops.forward_plan(B, N, E, D)
        kinds.add((p.split > 1, p.staged))
        before = segment_ops.launches['segment_mean']
        out, counts = segment_ops.segment_mean_counts(*args, N, plan)
        again, _ = segment_ops.segment_mean_counts(*args, N, plan)
        no_grad = segment_ops.segment_mean(*args, N)
        ref = segment_ops.segment_mean_ref(*args, N)
        cpu_out, cpu_counts = segment_ops.segment_mean_counts_ref(*cpu, N)
        torch.cuda.synchronize()
        assert segment_ops.launches['segment_mean'] == before + 3
        assert torch.equal(out, again) and torch.equal(out, no_grad)
        assert torch.equal(out.cpu(), cpu_out), (B, plan)
        assert torch.equal(counts.cpu(), cpu_counts), (B, plan)
        assert float((out - ref).abs().max()) <= ATOL
    assert kinds == {(False, False), (True, False), (False, True)}


@pytest.mark.gpu
def test_general_plan_and_any_width_on_card():
    """The general plan and the runtime-width instantiation on the card:
    at the trainer's graph (E=3000, N=1344) each gives the bits of the
    plan forward_plan chooses there, at D 16, 24 and 6 (scalar loads) and
    the CPU plain version's bits there; at 40,000 edge slots
    (the general plan chosen) and D 24, 6 and 1, the CPU plain version's
    bits and counts, and the backward equal to its plain version; then
    the general plan's sorts on hubs of 300 and 10,000 keys (skips
    without a CUDA device; chip_smoke.py runs the same at
    kernel_bench.RANGE_SHAPES)."""
    if not torch.cuda.is_available():
        pytest.skip('requires a CUDA device')
    dev = torch.device('cuda')
    for B, E, N, D in ((8, 3000, 1344, 16), (8, 3000, 1344, 24),
                       (8, 3000, 1344, 6), (2, 40000, 1344, 24), (2, 40000, 1344, 6),
                       (2, 40000, 1344, 1)):
        h, edges, mask, N = _graph('masked_sentinel', B=B, E=E, N=N, D=D)
        cpu = (torch.as_tensor(h), torch.as_tensor(edges),
               torch.as_tensor(mask))
        args = tuple(x.to(dev) for x in cpu)
        chosen = segment_ops.forward_plan(B, N, E, D)
        plans = [chosen, segment_ops.general_plan(),
                 chosen._replace(any_width=True)]
        want = segment_ops.segment_mean_counts_ref(*cpu, N)
        for plan in plans:
            out, counts = segment_ops.segment_mean_counts(*args, N, plan)
            assert torch.equal(out.cpu(), want[0]), (B, E, D, plan)
            assert torch.equal(counts.cpu(), want[1]), (B, E, D, plan)
        g = torch.randn(B, N, D, device=dev)
        assert torch.equal(
            segment_ops.segment_mean_backward(g, counts, *args[1:]),
            segment_ops.segment_mean_backward_ref(g, counts, *args[1:]))
    # the general plan's sorts: buckets of ~42 keys (each sorted by a CTA),
    # a hub of 300 keys (sorted in shared memory) and one of 10,000 (in
    # device memory), still bipartite: the CPU plain version's bits
    h, edges, mask, N = _graph('bipartite', B=2, E=40000, N=1344, D=8)
    edges[:, :300, 0] = 0
    edges[:, 300:10300, 0] = 1
    mask[:, :10300] = True
    cpu = (torch.as_tensor(h), torch.as_tensor(edges), torch.as_tensor(mask))
    assert segment_ops.forward_plan(2, N, 40000, 8).general
    out, counts = segment_ops.segment_mean_counts(
        *(x.to(dev) for x in cpu), N)
    want = segment_ops.segment_mean_counts_ref(*cpu, N)
    assert float(want[1][:, 1].min()) >= 10000
    assert torch.equal(out.cpu(), want[0]) and torch.equal(counts.cpu(),
                                                           want[1])


def _bench_cases():
    from urban_tpu_torch import kernel_bench as kb
    return [(name, b, n, e, d) for name, e, n, d in kb.SHAPES + (
        kb.DP_RANK_UPDATE,) for b in kb.BATCHES.get(name, (kb.B,))]


def _shared(n, e, d, split, threads, staged):
    return segment_ops.forward_shared_bytes(n, e, d, split, threads, staged)


def _resident(plan):
    """CTAs of a plan one SM is sure to hold: the kernel's launch bounds
    keep 1024 threads an SM within the registers, and the shared memory
    (with the static bytes and what the runtime reserves) allows the
    rest."""
    return min(1024 // plan.threads, segment_ops.SHARED_BYTES_PER_SM // (
        plan.shared_bytes + segment_ops.FORWARD_STATIC_BYTES
        + segment_ops.SHARED_BYTES_RESERVED))


def test_forward_plan_fits_every_bench_shape():
    """Every shape and batch that kernel_bench and chip_smoke.py time gets
    a plan: a split of 1-8 CTAs (1 where staged), a block size the kernel
    is built for, and the shared memory forward_shared_bytes gives, with
    the kernel's static bytes within one CTA's 232,448."""
    for name, b, n, e, d in _bench_cases():
        plan = segment_ops.forward_plan(b, n, e, d)
        assert plan.split in segment_ops.FORWARD_SPLITS, name
        assert plan.threads in segment_ops.FORWARD_THREADS, name
        assert not plan.staged or plan.split == 1
        assert plan.shared_bytes == _shared(n, e, d, plan.split,
                                            plan.threads, plan.staged)
        assert 0 < plan.shared_bytes + segment_ops.FORWARD_STATIC_BYTES \
            <= 232448, (name, b, plan)


def test_forward_plan_runs_in_one_wave():
    """Where the batch fits 132 SMs, the plan reads h from global memory
    and runs the batch in one wave of 1024-thread CTAs, with the largest
    split (at most 8) whose CTAs fit. Past 132 it stages each element's
    rows in one CTA of 1024 threads where they fit beside the CSR, else it
    takes two CTAs of 512 threads an element, two an SM. B = 1 gets a
    cluster of 8, the evals' B = 64 a split of 2."""
    sms = segment_ops.NUM_SMS
    for name, b, n, e, d in _bench_cases():
        plan = segment_ops.forward_plan(b, n, e, d)
        staged = _shared(n, e, d, 1, 1024, True)
        if b > sms:
            fits = staged + segment_ops.FORWARD_STATIC_BYTES <= 232448
            assert plan.staged == fits, (name, b, plan)
            assert plan[:3] == ((1, 1024, True) if fits else (2, 512, False))
            assert _resident(plan) == (1 if fits else 2)
            continue
        assert not plan.staged and plan.threads == 1024, (name, b, plan)
        assert b * plan.split <= sms * _resident(plan)
        assert plan.split == max(s for s in segment_ops.FORWARD_SPLITS
                                 if b * s <= sms), (name, b, plan)
    assert segment_ops.forward_plan(1, 1344, 3000, 16).split == 8
    assert segment_ops.forward_plan(64, 1344, 3000, 16).split == 2
    assert segment_ops.forward_plan(128, 1344, 3000, 16).split == 1
    assert segment_ops.forward_plan(256, 1344, 3000, 16).staged
    assert segment_ops.forward_plan(256, 1344, 4000, 16)[:3] == (2, 512, False)


def _pr14_takes(n, e):
    """The graphs the one-CTA-an-element kernel before forward_plan took:
    (3 N + 1 + 4 E) ints and one per warp of its 512 threads in one
    block's 232,448 bytes."""
    return (3 * n + 1 + 4 * e) * 4 + 16 * 4 <= 232448


def _takes(n, e, d):
    return (2 * e + 1 <= 0xFFFF and _shared(n, e, d, 1, 1024, False)
            + segment_ops.FORWARD_STATIC_BYTES <= 232448)


def _shared_memory_plan(plan, b, n, e, d):
    """A plan of the shared-memory kind for (B, N, E, D): a split of the
    kernel's, a block size it is built for, its shared memory, and the
    kernel's own choice of instantiation by D (no any_width override)."""
    return (not plan.general and plan.split in segment_ops.FORWARD_SPLITS
            and plan.threads in segment_ops.FORWARD_THREADS
            and not plan.any_width
            and plan.shared_bytes == _shared(n, e, d, plan.split,
                                             plan.threads, plan.staged))


def test_forward_plan_accepts_every_graph_taken_before():
    """Every (N, E) that the kernel took before forward_plan is still
    taken by the same shared-memory plan, at every batch and templated
    width, on a grid of E with the largest N each took; past that N, and
    where the keys 2 e + 1 pass 16 bits, the general plan is chosen; only
    invalid inputs (no nodes, no width) raise ValueError. A width without
    an instantiation of its own takes the shared-memory plans too (the
    kernel then runs its runtime-width one)."""
    for e in range(0, 14600, 97):
        n_old = max((n for n in (
            (232448 - 64 - 4 - 16 * e) // 12 - k for k in range(3))
            if n > 0 and _pr14_takes(n, e)), default=0)
        if n_old == 0:
            continue
        for n in (1, n_old // 2, n_old):
            for d in segment_ops.TEMPLATED_DIMS:
                assert _takes(n, e, d)
                for b in (1, 64, 192, 256):
                    plan = segment_ops.forward_plan(b, n, e, d)
                    assert plan.shared_bytes <= 232448
                    assert _shared_memory_plan(plan, b, n, e, d)
        lo, hi = n_old, 10 ** 6   # the largest N taken at this E
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if _takes(mid, e, 16) else (lo, mid)
        assert _shared_memory_plan(segment_ops.forward_plan(256, lo, e, 16),
                                   256, lo, e, 16)
        assert segment_ops.forward_plan(256, lo + 1, e, 16) == \
            segment_ops.general_plan()
    with pytest.raises(ValueError):
        segment_ops.forward_plan(1, 0, 10, 16)
    with pytest.raises(ValueError):
        segment_ops.forward_plan(1, 10, 10, 0)
    assert segment_ops.forward_plan(1, 10, 32767, 16).general
    assert segment_ops.forward_plan(1, 10, 32768, 16).general
    plan = segment_ops.forward_plan(1, 10, 10, 12)
    assert _shared_memory_plan(plan, 1, 10, 10, 12)


def test_graph_not_taken_raises_before_any_launch(monkeypatch):
    """On a CUDA tensor a graph past what one CTA's shared memory holds
    launches the general plan, once, with the scratch of
    forward_scratch_words allocated on the tensor's device (the card's
    path with the device stood in for, so that it runs here: the scratch
    lands on the CPU)."""
    n = 1
    while _takes(n * 2, 4, 8):
        n *= 2
    while _takes(n + 1, 4, 8):
        n += 1
    h = torch.zeros((1, 4, 8))
    edges = torch.zeros((1, 4, 2), dtype=torch.int32)
    mask = torch.ones((1, 4), dtype=torch.bool)
    called, allocated = [], []
    empty = torch.empty

    def on_card(*shape, dtype=None, device=None):
        allocated.append((shape, dtype, device))
        return empty(*shape, dtype=dtype)
    monkeypatch.setattr(segment_ops, '_device',
                        lambda t: torch.device('cuda'))
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch, 'empty', on_card)
    monkeypatch.setattr(segment_ops, 'device_limits',
                        lambda dev: segment_ops.H100_SXM)
    monkeypatch.setattr(segment_ops, '_stream', lambda dev: 0)
    monkeypatch.setattr(segment_ops, '_launch',
                        lambda *a: called.append(a))
    assert segment_ops.forward_plan(1, n, 4, 8).general is False
    plan = segment_ops.forward_plan(1, n + 1, 4, 8)
    assert plan == segment_ops.general_plan()
    assert plan.shared_bytes == segment_ops.forward_shared_bytes(
        n + 1, 4, 8, 1, plan.threads, False, general=True)
    out, counts = segment_ops.segment_mean_counts(h, edges, mask, n + 1)
    assert out.shape == (1, n + 1, 8) and counts.shape == (1, n + 1)
    (args,) = called
    words = segment_ops.forward_scratch_words(1, n + 1, 4)
    assert words == (n + 1) + (n + 2) + 8
    assert allocated[-1] == ((words,), torch.int32, torch.device('cuda'))
    assert all(dev == torch.device('cuda') for *_, dev in allocated)
    assert args[:2] == ('segment_mean', 'segment_mean_general_f32')
    assert args[8:] == (words, 1, 4, n + 1, 8, 0)


def _props(sms, per_block, per_sm):
    return types.SimpleNamespace(multi_processor_count=sms,
                                 shared_memory_per_block_optin=per_block,
                                 shared_memory_per_multiprocessor=per_sm)


def test_plans_read_the_cards_limits(monkeypatch):
    """The plans take the SM count and the shared-memory limits of the
    tensor's card from torch.cuda.get_device_properties: the H100 SXM's
    give the default plans; a card of 114 SMs (an H100 PCIe) moves the
    staging threshold to B > 114 and each split's to B x split <= 114;
    a card with 99 KB a block (sm_86) stages no trainer graph and takes
    the backward's tile of 8."""
    sxm = segment_ops.limits_of(_props(132, 232448, 233472))
    assert sxm == segment_ops.H100_SXM and sxm.reserved_bytes == 1024
    pcie = segment_ops.limits_of(_props(114, 232448, 233472))
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda dev: _props(114, 232448, 233472))
    segment_ops.device_limits.cache_clear()
    try:
        assert segment_ops.device_limits(torch.device('cuda', 1)) == pcie
    finally:
        segment_ops.device_limits.cache_clear()

    def plan(b, limits):
        return segment_ops.forward_plan(b, 1344, 3000, 16, limits)
    for limits, sms in ((sxm, 132), (pcie, 114)):
        assert plan(sms, limits)[:3] == (1, 1024, False)
        assert plan(sms + 1, limits)[:3] == (1, 1024, True)
        for split in (8, 4, 2):
            b = sms // split
            assert plan(b, limits).split == split
            assert plan(b + 1, limits).split == split // 2
    assert plan(128, sxm).split == 1 and plan(128, pcie).staged
    assert segment_ops.forward_plan(256, 1344, 3000, 16) == plan(256, sxm)
    ampere = segment_ops.limits_of(_props(84, 101376, 102400))
    assert plan(256, ampere)[:3] == (2, 512, False)
    assert segment_ops.backward_plan(1344, 16) == \
        segment_ops.backward_plan(1344, 16, pcie) == (16, 86016, 512)
    assert segment_ops.backward_plan(1344, 16, ampere) == (8, 43008, 512)


@pytest.mark.parametrize('B,E', [(0, 96), (3, 0), (0, 0)])
def test_empty_batch_gives_zeros_without_launch(B, E):
    """No rows (a data-parallel rank's share of a minibatch) or no edges:
    the forward, its counts and the backward are zeros of their shapes,
    through the wrappers' guard, which the card's path takes too, and no
    launch is counted."""
    N, D = 40, 8
    h = torch.zeros((B, E, D), requires_grad=True)
    edges = torch.zeros((B, E, 2), dtype=torch.int32)
    mask = torch.ones((B, E), dtype=torch.bool)
    before = dict(segment_ops.launches)
    out, counts = segment_ops.segment_mean_counts(h.detach(), edges, mask, N)
    assert out.shape == (B, N, D) and counts.shape == (B, N)
    assert not out.any() and not counts.any()
    dh = segment_ops.segment_mean_backward(torch.ones((B, N, D)), counts,
                                           edges, mask)
    assert dh.shape == (B, E, D) and not dh.any()
    segment_ops.segment_mean(h, edges, mask, N).sum().backward()
    assert h.grad.shape == (B, E, D)
    assert segment_ops.launches == before


@pytest.mark.parametrize('width', [1, 6, 24, 48, 128])
def test_any_width_matches_jax_on_a_large_graph(width):
    """segment_mean, its counts and SegmentMean's gradient at any width,
    on a graph of 40,000 edge slots and 1,344 nodes (the HLG trainer's
    nodes with max_num_edges 40000), against JAX's one-hot Pallas kernel
    (interpret mode) and segment_mean_xla, and the gradient against
    jax.grad of segment_mean_xla on the unmasked rows (segment_mean_xla
    scatters masked rows too: tests/test_torch_segment_grad.py). atol =
    rtol = 1e-5: f32 sums in another order."""
    import jax
    import jax.numpy as jnp
    from urban_tpu.ops.pallas import segment_ops as jseg
    h, edges, mask, N = _graph('masked_sentinel', B=2, E=40000, N=1344,
                               D=width, seed=width)
    g = np.random.default_rng(width + 1).normal(
        size=(2, N, width)).astype(np.float32)
    th = torch.as_tensor(h).requires_grad_()
    out = segment_ops.segment_mean(th, torch.as_tensor(edges),
                                   torch.as_tensor(mask), N)
    dh, = torch.autograd.grad(out, th, torch.as_tensor(g))
    _, counts = segment_ops.segment_mean_counts(
        torch.as_tensor(h), torch.as_tensor(edges), torch.as_tensor(mask), N)
    jh, je, jm = jnp.asarray(h), jnp.asarray(edges), jnp.asarray(mask)
    xla = np.asarray(jseg.segment_mean_xla(jh, je, jm, N))
    pallas = np.asarray(jseg.segment_mean_onehot_pallas(jh, je, jm, N,
                                                        interpret=True))
    for want in (xla, pallas):
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=ATOL,
                                   atol=ATOL)
    ones = jseg.segment_mean_onehot_pallas(jnp.ones_like(jh), je, jm, N,
                                           interpret=True)
    np.testing.assert_allclose(
        (counts / (counts + 1e-6)).numpy()[..., None].repeat(width, -1),
        np.asarray(ones), rtol=ATOL, atol=ATOL)
    j_dh = np.asarray(jax.grad(lambda x: jnp.sum(
        jseg.segment_mean_xla(x, je, jm, N) * jnp.asarray(g)))(jh))
    np.testing.assert_allclose(dh.numpy()[mask], j_dh[mask], rtol=ATOL,
                               atol=ATOL)
    assert not dh.numpy()[~mask].any()


# (B, N, E, D) the shared-memory plans do not take: keys past 16 bits, or a
# CSR past one CTA (the HLG trainer's nodes with 28,100 edge slots)
GENERAL_GRAPHS = [(256, 1344, 28100, 16), (256, 1344, 40000, 24),
                  (8, 40000, 100000, 16), (1, 1344, 40000, 24)]


def test_forward_plan_takes_every_graph():
    """forward_plan returns a plan, and raises nothing, for graphs past
    one CTA or 16-bit keys (the general plan) and for every width at the
    graphs the shared-memory plans take; kernel_bench's range shapes get
    the plans their rows are timed with."""
    from urban_tpu_torch import kernel_bench as kb
    for b, n, e, d in GENERAL_GRAPHS:
        assert segment_ops.forward_plan(b, n, e, d) == \
            segment_ops.general_plan()
    for d in (1, 3, 6, 12, 24, 48, 128, 1024):
        for e in (1000, 3000):
            for b in (1, 64, 256):
                plan = segment_ops.forward_plan(b, 1344, e, d)
                assert _shared_memory_plan(plan, b, 1344, e, d), (b, d)
            # staged only past the SMs, where the rows fit beside the CSR
            # and the bulk copy moves whole 16-byte pieces (3000 rows of
            # 24 floats or more do not fit)
            fits = _shared(1344, e, d, 1, 1024, True) + 16 <= 232448
            assert plan.staged == (fits and d % 4 == 0), (e, d)
            assert plan.staged == (d in (12,) or e == 1000 and d in (
                12, 24, 48)), (e, d)
    for name, e, n, d in kb.RANGE_SHAPES:
        for b in kb.BATCHES[name]:
            plan = segment_ops.forward_plan(b, n, e, d)
            assert plan.general == (e > 28029), (name, b)
            assert plan.general or _shared_memory_plan(plan, b, n, e, d)
