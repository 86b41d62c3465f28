"""The port's segment mean (urban_tpu_torch.ops.segment_ops) against the JAX
package's XLA scatter and its Pallas kernel (interpret mode).

Same inputs, made with numpy from a seed, go to both packages. Tolerance
1e-5 absolute: f32 sums of a few O(1) terms, taken in another order.

JAX is imported inside the test that uses it, so that the card-only test
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


@pytest.mark.parametrize('case', ['bipartite', 'masked_sentinel',
                                  'self_loop'])
def test_ref_matches_xla_and_pallas(case):
    import jax.numpy as jnp
    from urban_tpu.ops.pallas.segment_ops import (segment_mean_onehot_pallas,
                                                  segment_mean_xla)
    h, edges, mask, N = _graph(case)
    out = segment_ops.segment_mean_ref(torch.as_tensor(h),
                                       torch.as_tensor(edges),
                                       torch.as_tensor(mask), N).numpy()
    xla = np.asarray(segment_mean_xla(jnp.asarray(h), jnp.asarray(edges),
                                      jnp.asarray(mask), N))
    pallas = np.asarray(segment_mean_onehot_pallas(
        jnp.asarray(h), jnp.asarray(edges), jnp.asarray(mask), N,
        interpret=True))
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
    before = segment_ops.launches
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


@pytest.mark.gpu
def test_kernel_on_card():
    """CUDA kernel == plain version on the card, bitwise repeatable (skips
    without a CUDA device; chip_smoke.py runs the same check at the
    rollout's shape)."""
    if not torch.cuda.is_available():
        pytest.skip('requires a CUDA device')
    h, edges, mask, N = _graph('masked_sentinel', B=4, E=256, N=100, D=16)
    dev = torch.device('cuda')
    args = (torch.as_tensor(h, device=dev), torch.as_tensor(edges, device=dev),
            torch.as_tensor(mask, device=dev))
    before = segment_ops.launches
    out = segment_ops.segment_mean(*args, N)
    again = segment_ops.segment_mean(*args, N)
    ref = segment_ops.segment_mean_ref(*args, N)
    torch.cuda.synchronize()
    assert segment_ops.launches == before + 2
    assert torch.equal(out, again)
    assert float((out - ref).abs().max()) <= ATOL
