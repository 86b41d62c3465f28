"""Area conservation of the port's polygon difference against the JAX
package's, on fixtures where a convex cutter meets a square or a strip in
the degenerate ways the slicer produces: a flange (the cutter sticks out
of one side), a bridge (it cuts the ring in two), an annulus (it lies
strictly inside), a point touch (it lies inside and touches the boundary
at one vertex) and a pinch (the remainder is two lobes joined at a point
of the cutter's boundary, the geometry of grid seed 103's divergence).

Each case goes through the port's ``arc_pieces`` (both sides of the
cutter) and, for quad cutters, ``difference_pieces_by_quad``, and through
the JAX functions under jax.jit: vertex counts and overflow flags equal,
coordinates within rtol 1e-5 / atol 1e-4. Then the pieces' areas must sum
to the ring's area minus the cutter's overlap (the intersection pieces to
the overlap), within 1e-4 relative. ``arc_pieces`` cannot hold a hole: for
the annulus it returns the ring with its overflow flag set, which the env
step turns into a failure. The point touch is a fault of the reference
itself, which the port carries."""
import functools

import numpy as np
import jax
import pytest
import torch

from urban_tpu.jaxenv import geometry as jg
from urban_tpu_torch.torchenv import geometry as tg

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
AREA_RTOL = 1e-4
KV, KH = 16, 8
SQUARE = [(0, 0), (8, 0), (8, 8), (0, 8)]
STRIP = [(0, 0), (8, 0), (8, 4), (0, 4)]

# name: (ring, convex CCW cutter, the cutter's overlap with the ring)
CASES = {
    'flange': (SQUARE, [(2, -2), (6, -2), (6, 3), (2, 3)], 12.0),
    'bridge': (SQUARE, [(3, -1), (5, -1), (5, 9), (3, 9)], 16.0),
    'annulus': (SQUARE, [(3, 3), (5, 3), (5, 5), (3, 5)], 4.0),
    'point_touch': (SQUARE, [(4, 0), (6, 2), (4, 4), (2, 2)], 8.0),
    # the triangle's apex touches the strip's top edge at (4, 4): two
    # difference runs whose tail and head meet there, linked at distance 0
    'pinch': (STRIP, [(2, -1), (6, -1), (4, 4)], 6.4),
}
PINCH_OVERRIDE = pytest.mark.xfail(
    strict=True, reason='the reference\'s pinch override '
    '(urban_tpu/jaxenv/geometry.py:692-693) zeroes the closing walk of a '
    'self-linked run, so the hull hole is lost and the filled ring comes '
    'back (ROADMAP queue 3, "Medium")')


def _pad(pts, k):
    r = np.zeros((k, 2), np.float32)
    r[:len(pts)] = pts
    return r, np.int32(len(pts))


def _inputs(name):
    ring, hull, overlap = CASES[name]
    r, n = _pad(ring, KV)
    h, nh = _pad(hull, KH)
    return r, n, h, nh, overlap


def _areas(pieces, counts, area_fn):
    return float(sum(area_fn(p, c) for p, c in zip(pieces, counts)))


# compiled once per side: every fixture has the same shapes
_JAX_ARC = {k: jax.jit(functools.partial(jg.arc_pieces, keep_inside=k))
            for k in (False, True)}
_JAX_WEDGES = jax.jit(jg.difference_pieces_by_quad)


def _jax_arc(r, n, h, nh, keep_inside):
    return _JAX_ARC[keep_inside](r, n, h, nh)


def _port_arc(r, n, h, nh, keep_inside):
    return tg.arc_pieces(*(torch.as_tensor(x) for x in (r, n, h, nh)),
                         keep_inside)


def _assert_same(got, want, what):
    for k, (b, a) in enumerate(zip(got, want)):
        a, b = np.asarray(a), b.numpy()
        if a.dtype.kind == 'f':
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=f'{what} output {k}')
        else:
            np.testing.assert_array_equal(b, a, err_msg=f'{what} output {k}')


@pytest.mark.parametrize('name', sorted(CASES))
def test_arc_pieces_match_jax(name):
    r, n, h, nh, _ = _inputs(name)
    for keep_inside in (False, True):
        _assert_same(_port_arc(r, n, h, nh, keep_inside),
                     _jax_arc(r, n, h, nh, keep_inside),
                     f'{name} keep_inside={keep_inside}')
    if len(CASES[name][1]) == 4:
        quad = np.asarray(CASES[name][1], np.float32)
        _assert_same(tg.difference_pieces_by_quad(
            torch.as_tensor(r), torch.as_tensor(n), torch.as_tensor(quad)),
            _JAX_WEDGES(r, n, quad),
            f'{name} wedges')


@pytest.mark.parametrize('name', [
    pytest.param(k, marks=PINCH_OVERRIDE) if k == 'point_touch' else k
    for k in sorted(CASES)])
def test_arc_pieces_conserve_area(name):
    r, n, h, nh, overlap = _inputs(name)
    ring_area = float(tg.ring_area(torch.as_tensor(r), torch.as_tensor(n)))
    for pkg, arc, area_fn in (('port', _port_arc, tg.ring_area),
                              ('jax', _jax_arc, jg.ring_area)):
        pieces, counts, overflow = arc(r, n, h, nh, False)
        # no hole fits the piece layout: the annulus comes back flagged,
        # and nothing else may
        assert bool(overflow) == (name == 'annulus'), (pkg, name)
        if bool(overflow):
            continue
        got = _areas(pieces, counts, area_fn)
        np.testing.assert_allclose(got, ring_area - overlap, rtol=AREA_RTOL,
                                   err_msg=f'{pkg} {name} difference')
        pieces, counts, overflow = arc(r, n, h, nh, True)
        assert not bool(overflow), (pkg, name)
        np.testing.assert_allclose(_areas(pieces, counts, area_fn), overlap,
                                   rtol=AREA_RTOL,
                                   err_msg=f'{pkg} {name} intersection')


@pytest.mark.parametrize('name', sorted(k for k, v in CASES.items()
                                        if len(v[1]) == 4))
def test_quad_wedges_conserve_area(name):
    """The wedge decomposition holds every quad case, the annulus and the
    point touch included."""
    r, n, _, _, overlap = _inputs(name)
    quad = np.asarray(CASES[name][1], np.float32)
    ring_area = float(tg.ring_area(torch.as_tensor(r), torch.as_tensor(n)))
    pieces, counts, overflow = tg.difference_pieces_by_quad(
        torch.as_tensor(r), torch.as_tensor(n), torch.as_tensor(quad))
    assert not bool(overflow)
    np.testing.assert_allclose(_areas(pieces, counts, tg.ring_area),
                               ring_area - overlap, rtol=AREA_RTOL)
    jp, jn, jo = _JAX_WEDGES(r, n, quad)
    assert not bool(jo)
    np.testing.assert_allclose(_areas(jp, jn, jg.ring_area),
                               ring_area - overlap, rtol=AREA_RTOL)
