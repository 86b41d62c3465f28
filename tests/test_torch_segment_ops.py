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
        'unsupported_width': (h[..., :6].contiguous(), edges, mask, N,
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
    a bipartite graph: the CPU plain version's bits and counts, within
    ATOL of the plain version on the card, bitwise repeatable, and the
    kernel the no-gradient segment_mean runs (skips without a CUDA device;
    chip_smoke.py runs the same checks at all three main-path shapes)."""
    if not torch.cuda.is_available():
        pytest.skip('requires a CUDA device')
    h, edges, mask, N = _graph('masked_sentinel', B=8, E=3000, N=1344, D=16)
    dev = torch.device('cuda')
    cpu = (torch.as_tensor(h), torch.as_tensor(edges), torch.as_tensor(mask))
    args = tuple(x.to(dev) for x in cpu)
    before = segment_ops.launches['segment_mean']
    out, counts = segment_ops.segment_mean_counts(*args, N)
    again, _ = segment_ops.segment_mean_counts(*args, N)
    no_grad = segment_ops.segment_mean(*args, N)
    ref = segment_ops.segment_mean_ref(*args, N)
    cpu_out, cpu_counts = segment_ops.segment_mean_counts_ref(*cpu, N)
    torch.cuda.synchronize()
    assert segment_ops.launches['segment_mean'] == before + 3
    assert torch.equal(out, again) and torch.equal(out, no_grad)
    assert torch.equal(out.cpu(), cpu_out)
    assert torch.equal(counts.cpu(), cpu_counts)
    assert float((out - ref).abs().max()) <= ATOL
