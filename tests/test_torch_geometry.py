"""The port's geometry (urban_tpu_torch.torchenv.geometry) against the JAX
package's (urban_tpu.jaxenv.geometry, under jax.jit) on seeded random
inputs: segments_cross, halfplane_clip_ring, envelope_rect,
clip_poly_by_convex_quad and difference_pieces_by_quad.

The predicate is exact, on random segments and on integer-lattice
segments, where collinear, touching and parallel pairs are common. Ring
outputs: vertex counts and overflow flags exact, coordinates within
rtol 1e-5 / atol 1e-4."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from urban_tpu.jaxenv import geometry as jg
from urban_tpu_torch.torchenv import geometry as tg

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
KV = 16


def _t(x):
    return torch.as_tensor(np.asarray(x))


def star_rings(rng, n):
    """n CCW star-shaped rings (KV, 2) with 3-10 vertices, zero padded."""
    rings = np.zeros((n, KV, 2), np.float32)
    nv = rng.integers(3, 11, n).astype(np.int32)
    for i in range(n):
        ang = np.sort(rng.uniform(0, 2 * np.pi, nv[i]))
        rad = rng.uniform(2.0, 10.0, nv[i])
        c = rng.uniform(-5.0, 5.0, 2)
        rings[i, :nv[i]] = c + np.stack([rad * np.cos(ang),
                                         rad * np.sin(ang)], -1)
    return rings, nv


def quads(rng, n):
    """n convex CCW quads: rotated rectangles around the origin."""
    out = []
    for _ in range(n):
        w, h = rng.uniform(2.0, 12.0, 2)
        th = rng.uniform(0, np.pi)
        rect = np.array([[-w, -h], [w, -h], [w, h], [-w, h]]) / 2
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        out.append(rect @ rot.T + rng.uniform(-3, 3, 2))
    return np.asarray(out, np.float32)


def assert_rings_close(got, want, what):
    for k, (a, b) in enumerate(zip(want, got)):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind == 'f':
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=f'{what} output {k}')
        else:
            np.testing.assert_array_equal(b, a, err_msg=f'{what} output {k}')


@pytest.mark.parametrize('kind', ['random', 'lattice'])
def test_segments_cross_matches_jax(kind):
    rng = np.random.default_rng(0)
    n = 4000
    if kind == 'random':
        pts = rng.normal(size=(4, n, 2)) * 50.0
    else:
        # endpoints on a 5 x 5 lattice: shared endpoints, collinear
        # overlaps, parallel and touching pairs
        pts = rng.integers(0, 5, (4, n, 2)) * 1.5
    pts = pts.astype(np.float32)
    want = np.asarray(jax.jit(jg.segments_cross)(*pts))
    got = tg.segments_cross(*(_t(p) for p in pts)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < n
    if kind == 'lattice':
        # touching at an endpoint and collinear overlap are not crossings
        p = _t(np.float32([[0, 0], [0, 0], [0, 0]]))
        q = _t(np.float32([[2, 0], [2, 2], [2, 0]]))
        a = _t(np.float32([[1, 0], [2, 2], [1, -1]]))
        b = _t(np.float32([[3, 0], [4, 0], [1, 1]]))
        assert tg.segments_cross(p, q, a, b).tolist() == [False, False, True]


def test_halfplane_clip_ring_matches_jax():
    rng = np.random.default_rng(1)
    n = 64
    rings, nv = star_rings(rng, n)
    a = rng.uniform(-8, 8, (n, 2)).astype(np.float32)
    b = (a + rng.normal(size=(n, 2))).astype(np.float32)
    keep = rng.random(n) < 0.5
    want = jax.jit(jax.vmap(jg.halfplane_clip_ring))(rings, nv, a, b, keep)
    got = torch.func.vmap(tg.halfplane_clip_ring)(
        _t(rings), _t(nv), _t(a), _t(b), _t(keep))
    assert_rings_close(got, want, 'clip')
    for side in (True, False):     # a Python bool for keep_left
        w = jax.jit(lambda r, n_, p, q: jg.halfplane_clip_ring(
            r, n_, p, q, side))(rings[0], nv[0], a[0], b[0])
        g = tg.halfplane_clip_ring(_t(rings[0]), _t(nv[0]), _t(a[0]),
                                   _t(b[0]), side)
        assert_rings_close(g, w, f'clip keep_left={side}')
    # both kept and cut rings occur
    n_out = np.asarray(want[1])
    assert (n_out == 0).any() and (n_out > 0).any()


def test_envelope_rect_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(32, 12, 2)).astype(np.float32) * 20
    mask = rng.random((32, 12)) < 0.6
    mask[:, 0] = True
    want = jax.jit(jax.vmap(jg.envelope_rect))(pts, mask)
    got = torch.func.vmap(tg.envelope_rect)(_t(pts), _t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('fn', ['clip_poly_by_convex_quad',
                                'difference_pieces_by_quad'])
def test_quad_boolean_ops_match_jax(fn):
    rng = np.random.default_rng(3)
    n = 48
    rings, nv = star_rings(rng, n)
    q = quads(rng, n)
    want = jax.jit(jax.vmap(getattr(jg, fn)))(rings, nv, q)
    got = torch.func.vmap(getattr(tg, fn))(_t(rings), _t(nv), _t(q))
    assert_rings_close(got, want, fn)
    counts = np.asarray(want[1])
    assert (counts > 0).any() and (counts == 0).any()
