"""The gradient of the port's segment mean (urban_tpu_torch.ops.segment_ops:
SegmentMean, the counts-returning forward and the backward) against
jax.grad of the JAX package's XLA scatter and against autograd of the
port's plain version.

Same inputs, made with numpy from a seed, go to both packages. Tolerance
1e-5 absolute: f32 sums and quotients of a few O(1) terms, taken in another
order. segment_mean_xla scatters the rows of masked edges too (only its
counts are masked), so its gradient has rows there that the port's kernels
leave zero: against JAX, only unmasked rows are compared (in the model,
gather_to_edges zeroes those rows beforehand).

JAX is imported inside the tests that use it, so that the card-only test
collects on a machine without JAX:
    python -m pytest tests/test_torch_segment_grad.py -m gpu --noconftest
"""
import numpy as np
import pytest
import torch

from urban_tpu_torch.ops import segment_ops

torch.set_num_threads(1)

ATOL = 1e-5
CASES = ['bipartite', 'masked_sentinel', 'self_loop', 'out_of_range']


def _graph(case, B=3, E=96, N=40, D=8, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, E, D)).astype(np.float32)
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
    elif case == 'out_of_range':
        # an endpoint at or above N adds nothing and passes no gradient
        # (JAX would wrap a negative index around, the port drops it)
        edges[:, :4, 0] = N + 2
        edges[:, 4:8, 1] = N
        mask[:, :8] = True
    h = np.where(mask[..., None], h, 0.0).astype(np.float32)
    g = rng.normal(size=(B, N, D)).astype(np.float32)
    return h, edges, mask, N, g


def _torch(*arrays, device='cpu'):
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def _port_grad(h, edges, mask, N, g):
    th = torch.as_tensor(h).requires_grad_()
    out = segment_ops.segment_mean(th, *_torch(edges, mask), N)
    dh, = torch.autograd.grad(out, th, torch.as_tensor(g))
    return out, dh


def _ref_grad(h, edges, mask, N, g):
    th = torch.as_tensor(h).requires_grad_()
    out = segment_ops.segment_mean_ref(th, *_torch(edges, mask), N)
    dh, = torch.autograd.grad(out, th, torch.as_tensor(g))
    return dh


@pytest.mark.parametrize('case', CASES)
def test_segment_mean_grad_goes_through_segment_mean_function(case):
    """Wherever h_edges requires a gradient, segment_mean returns a result
    of the SegmentMean autograd function, the one that carries the
    gradient through the kernels on a CUDA device; without grad mode, or
    without requires_grad, it returns a plain tensor."""
    h, edges, mask, N, _ = _graph(case)
    th = torch.as_tensor(h).requires_grad_()
    out = segment_ops.segment_mean(th, *_torch(edges, mask), N)
    assert out.requires_grad
    assert type(out.grad_fn).__name__ == 'SegmentMeanBackward'
    with torch.no_grad():
        assert segment_ops.segment_mean(th, *_torch(edges, mask),
                                        N).grad_fn is None
    assert segment_ops.segment_mean(torch.as_tensor(h), *_torch(edges, mask),
                                    N).grad_fn is None


@pytest.mark.parametrize('case', CASES)
def test_cpu_backward_matches_jax_grad_and_plain_autograd(case):
    import jax
    import jax.numpy as jnp
    from urban_tpu.ops.pallas.segment_ops import segment_mean_xla
    h, edges, mask, N, g = _graph(case, seed=1)
    out, dh = _port_grad(h, edges, mask, N, g)

    def loss(x):
        return jnp.sum(segment_mean_xla(x, jnp.asarray(edges),
                                        jnp.asarray(mask), N)
                       * jnp.asarray(g))
    j_dh = np.asarray(jax.grad(loss)(jnp.asarray(h)))
    np.testing.assert_allclose(dh.numpy()[mask], j_dh[mask], rtol=0,
                               atol=ATOL)
    assert np.all(dh.numpy()[~mask] == 0.0)
    np.testing.assert_allclose(dh.numpy(), _ref_grad(h, edges, mask, N, g),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize('case', CASES)
def test_counts_ref_and_backward_ref(case):
    """segment_mean_counts_ref's counts are the number of unmasked in-range
    endpoint matches (a self-loop twice), and segment_mean_backward_ref
    equals autograd of segment_mean_ref."""
    h, edges, mask, N, g = _graph(case, seed=2)
    out, counts = segment_ops.segment_mean_counts_ref(*_torch(h, edges, mask),
                                                      N)
    want = np.zeros((h.shape[0], N), np.float32)
    for b in range(h.shape[0]):
        for e in np.flatnonzero(mask[b]):
            for n in edges[b, e]:
                if 0 <= n < N:
                    want[b, n] += 1
    np.testing.assert_array_equal(counts.numpy(), want)
    assert torch.equal(out, segment_ops.segment_mean_ref(
        *_torch(h, edges, mask), N))
    dh = segment_ops.segment_mean_backward_ref(
        torch.as_tensor(g), counts, *_torch(edges, mask))
    np.testing.assert_allclose(dh.numpy(), _ref_grad(h, edges, mask, N, g),
                               rtol=0, atol=ATOL)


def test_per_edge_wrapper_on_cpu_runs_plain_version():
    h, edges, mask, N, g = _graph('bipartite', seed=3)
    before = dict(segment_ops.launches)
    out, counts = segment_ops.segment_mean_counts(*_torch(h, edges, mask), N)
    ref, ref_counts = segment_ops.segment_mean_counts_ref(
        *_torch(h, edges, mask), N)
    assert torch.equal(out, ref) and torch.equal(counts, ref_counts)
    dh = segment_ops.segment_mean_backward(torch.as_tensor(g), counts,
                                           *_torch(edges, mask))
    assert torch.equal(dh, segment_ops.segment_mean_backward_ref(
        torch.as_tensor(g), counts, *_torch(edges, mask)))
    assert segment_ops.launches == before


def _bad_backward_inputs():
    h, edges, mask, N, g = _graph('bipartite')
    g, edges, mask = _torch(g, edges, mask)
    counts = segment_ops.segment_mean_counts_ref(torch.as_tensor(h), edges,
                                                 mask, N)[1]
    return {
        'grad_float64': (g.double(), counts, edges, mask, TypeError),
        'counts_float64': (g, counts.double(), edges, mask, TypeError),
        'counts_shape': (g, counts[:, :-1], edges, mask, ValueError),
        'edges_int64': (g, counts, edges.long(), mask, TypeError),
        'mask_shape': (g, counts, edges, mask[:, :-1], ValueError),
        'grad_rank': (g[0], counts, edges, mask, ValueError),
        'unsupported_width': (g[..., :6].contiguous(), counts, edges, mask,
                              ValueError),
        'grad_not_contiguous': (g.transpose(0, 1).contiguous().transpose(0, 1),
                                counts, edges, mask, ValueError),
        # contiguous, but 4 bytes past a 16-byte boundary: the kernel reads
        # grad_out as float4
        'grad_not_aligned': (_misaligned(g), counts, edges, mask, ValueError),
    }


def _misaligned(t):
    """A contiguous float32 copy of t that starts 4 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 3, dtype=t.dtype)
    off = (1 - flat.data_ptr() // 4) % 4
    out = flat[off:off + t.numel()].view(t.shape).copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize('name', sorted(_bad_backward_inputs()))
def test_backward_wrapper_rejects_bad_inputs(name):
    g, counts, edges, mask, exc = _bad_backward_inputs()[name]
    with pytest.raises(exc):
        segment_ops.segment_mean_backward(g, counts, edges, mask)


# the largest N the forward kernel takes: (3 N + 1 + 4 E) ints of shared
# memory and one per warp of its 512 threads within one block's limit
# (csrc/segment_mean.cu, shared_bytes and segment_mean_fits), at E = 0
FORWARD_MAX_NODES = (segment_ops.SHARED_BYTES_PER_BLOCK // 4 - 1 - 16) // 3


@pytest.mark.parametrize('width', segment_ops.SUPPORTED_DIMS)
def test_backward_plan_covers_every_graph_the_forward_takes(width):
    """For every N the forward accepts: the tile is a multiple of 4
    columns that divides D, the shared memory is the tile's N rows and
    within one block's limit, and the gather path (0 bytes, full rows) is
    taken exactly where not even 4 columns of N rows fit. Blocks have 512
    threads where two of them share an SM (as at the trainer's and the
    rollout's graphs), else 1024."""
    gather = []
    for n in range(1, FORWARD_MAX_NODES + 1):
        plan = segment_ops.backward_plan(n, width)
        assert plan.tile % 4 == 0 and width % plan.tile == 0
        assert plan.shared_bytes <= segment_ops.SHARED_BYTES_PER_BLOCK
        staged = plan.shared_bytes > 0
        two_per_sm = 2 * (plan.shared_bytes + 1024) <= 233472
        assert plan.threads == (512 if staged and two_per_sm else 1024)
        if staged:
            assert plan.shared_bytes == n * plan.tile * 4
        else:
            assert plan.tile == width and plan.shared_bytes == 0
            gather.append(n)
        assert staged == (n * 4 * 4 <= segment_ops.SHARED_BYTES_PER_BLOCK)
    assert gather == list(range(14529, FORWARD_MAX_NODES + 1))
    if width == 16:
        assert segment_ops.backward_plan(1344, 16) == (16, 86016, 512)
        assert segment_ops.backward_plan(1088, 16) == (16, 69632, 512)
    if width == 64:
        assert segment_ops.backward_plan(4096, 64) == (8, 131072, 1024)


@pytest.mark.gpu
def test_grad_kernels_on_card():
    """Forward kernel == plain version and its counts, bitwise repeatable;
    backward kernel == the plain backward bit for bit, with full rows (D=16),
    column tiles (D=64) and the gather path (N past what shared memory
    holds); SegmentMean on a CUDA tensor has a grad_fn and launches both
    kernels (skips without a CUDA device; chip_smoke.py runs the same checks
    at the main paths' shapes)."""
    if not torch.cuda.is_available():
        pytest.skip('requires a CUDA device')
    dev = torch.device('cuda')
    # (case, N, D): full rows at D=16, four tiles of 16 columns at D=64,
    # and the gather path at N=15000
    shapes = [(case, 100, 16) for case in CASES] + [('bipartite', 1000, 64),
                                                    ('bipartite', 15000, 16)]
    for case, n_nodes, width in shapes:
        h, edges, mask, N, g = _graph(case, B=4, E=256, N=n_nodes, D=width)
        plan = segment_ops.backward_plan(N, width)
        assert (plan.shared_bytes > 0) == (N < 15000)
        assert (plan.tile < width) == (width == 64)
        th, tedges, tmask, tg = _torch(h, edges, mask, g, device=dev)
        before = dict(segment_ops.launches)
        out, counts = segment_ops.segment_mean_counts(th, tedges, tmask, N)
        again, _ = segment_ops.segment_mean_counts(th, tedges, tmask, N)
        ref, ref_counts = segment_ops.segment_mean_counts_ref(th, tedges,
                                                              tmask, N)
        dh = segment_ops.segment_mean_backward(tg, counts, tedges, tmask)
        hk = th.clone().requires_grad_()
        out_k = segment_ops.segment_mean(hk, tedges, tmask, N)
        assert out_k.grad_fn is not None
        dk, = torch.autograd.grad(out_k, hk, tg)
        torch.cuda.synchronize()
        assert segment_ops.launches['segment_mean'] == \
            before['segment_mean'] + 3
        assert segment_ops.launches['segment_mean_backward'] == \
            before['segment_mean_backward'] + 2
        assert torch.equal(out, again)
        assert torch.equal(counts, ref_counts)
        assert float((out - ref).abs().max()) <= ATOL
        assert torch.equal(dh, segment_ops.segment_mean_backward_ref(
            tg, counts, tedges, tmask))
        assert torch.equal(dk, dh)
        # every other tile that fits, and the gather path, at either block
        # size, give the same bits
        tiles = [(t, N * t * 4) for t in (4, 8, 16, 32, 64) if width % t == 0
                 and N * t * 4 <= segment_ops.SHARED_BYTES_PER_BLOCK]
        for tile, size in tiles + [(width, 0)]:
            for threads in (512, 1024):
                other = segment_ops.BackwardPlan(tile, size, threads)
                assert torch.equal(segment_ops.segment_mean_backward(
                    tg, counts, tedges, tmask, other), dh), other
