"""Fixed-buffer geometry for the batched environment (counterpart of
urban_tpu/jaxenv/geometry.py).

Every function here works on ONE environment (a ``(KV, 2)`` ring with a
vertex count, a point table, ...) and is shape-static and branchless, so
``torch.func.vmap`` lifts it over environments (and over pieces or
candidates where the JAX code vmaps). No in-place ops, no ``.item()``, no
Python branch on tensor values.

Indexing follows JAX's semantics explicitly, because a PyTorch gather with
an out-of-range index raises where JAX clamps: ``take`` wraps negative
indices and clamps, and ``onehot_place``/``onehot_update``/``onehot_mask``
drop out-of-range or invalid targets, as a JAX scatter does. The one-hot
matmuls that the TPU needed for those scatters are index ops here, with the
same "at most one contributor per row" contract.

Rounding follows the reference's compiled f32 code: XLA contracts a
product feeding an add into a fused multiply-add, so ``fma``, ``cross`` and
``dot2`` compute those sites with one rounding (emulated in f64, where the
product of two f32 values is exact). Exact ties in the geometry (the
equidistant corners of a rectangle, equal-area bounding rectangles) then
break the same way as in the reference, and the port steps in lockstep with
it. Everything else is one eager op per kernel, so nothing else is fused:
the compensated (Dekker/TwoSum) products stay as written. Do not put this
module under ``torch.compile``, which would fuse them.
"""
from __future__ import annotations

import functools
import struct

import torch

BIG = 1e30
FLT_EPS = 1.1920929e-7   # np.finfo(np.float32).eps


# ---------------------------------------------------------------------------
# JAX-semantics indexing helpers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def const(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant tensor (value: a number or a tuple), made once per
    device: a step that a CUDA graph captures may not copy from the host.
    Never written to."""
    return torch.tensor(value, dtype=dtype, device=device)


def arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def take(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] along axis 0 with JAX gather semantics: negative indices wrap,
    then out-of-range indices clamp."""
    n = x.shape[0]
    i = i.long()
    i = torch.where(i < 0, i + n, i).clamp(0, n - 1)
    return x[i]


def set_at(x: torch.Tensor, i, value) -> torch.Tensor:
    """x.at[i].set(value) along axis 0; an out-of-range i is dropped."""
    hit = (arange(x.shape[0], x) == i).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(hit, value, x)


def norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis, sqrt(sum(x*x)) as jnp.linalg.norm."""
    n = sqrt(dot2(x, x))
    return n[..., None] if keepdim else n


def sqrt(x):
    """Square root rounded once to the nearest f32, as the reference's
    compiled code computes it (one hardware sqrt). The card's f32 sqrt is
    correctly rounded; ATen's CPU one is not on every host (1 ulp off on
    ~19% of inputs on an AMD EPYC), so the CPU takes it in f64: the root of
    an f32 lies at least 2**-49 (relative) from any f32 rounding boundary,
    so an f64 root a few f64 ulps off still rounds to the correctly rounded
    f32 root."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def _f32(v: float) -> float:
    return struct.unpack('f', struct.pack('f', v))[0]


# fdlibm's single-precision atan (glibc sysdeps/ieee754/flt-32/s_atanf.c
# and e_atan2f.c), with the decimal literals that the C code compiles.
# Argument reduction by interval of x >= 0 (breaks at 7/16, 11/16, 19/16,
# 39/16): xr = (a x - b) / (c + d x), atan(x) = hi + (lo + atan(xr)). Each
# row gives the same f32 operations as the C code's own expression for its
# interval: x, (2x - 1) / (2 + x), (x - 1) / (x + 1), (x - 1.5) /
# (1 + 1.5x), -1 / x; hi = lo = 0 turns its final step into x - x s.
_ATAN_BREAKS = (0.4375, 0.6875, 1.1875, 2.4375)
_ATAN_ROWS = tuple(tuple(_f32(v) for v in row) for row in (
    # a,   b,   c,   d,   hi,              lo
    (1.0, 0.0, 1.0, 0.0, 0.0, 0.0),
    (2.0, 1.0, 2.0, 1.0, 4.6364760399e-01, 5.0121582440e-09),
    (1.0, 1.0, 1.0, 1.0, 7.8539812565e-01, 3.7748947079e-08),
    (1.0, 1.5, 1.0, 1.5, 9.8279368877e-01, 3.4473217170e-08),
    (0.0, 1.0, 0.0, 1.0, 1.5707962513e+00, 7.5497894159e-08)))
_AT = tuple(_f32(v) for v in (
    3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
    -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
    6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
    -3.6531571299e-02, 1.6285819933e-02))
_ATAN_BIG = _f32(_ATAN_ROWS[4][4] + _ATAN_ROWS[4][5])   # x >= 2**25
_PI_O_2 = _f32(1.5707963705e+00)
_PI = _f32(3.1415927410e+00)
_PI_LO = _f32(-8.7422776573e-08)


def _atanf_nonneg(x):
    """fdlibm atanf for finite x >= 0, each f32 operation as the C code
    writes it (no contraction)."""
    breaks = const(_ATAN_BREAKS, torch.float32, x.device)
    rows = const(_ATAN_ROWS, torch.float32, x.device)
    a, b, c, d, hi, lo = rows[(x[..., None] >= breaks).sum(-1)].unbind(-1)
    xr = (a * x - b) / (c + d * x)
    z = xr * xr
    w = z * z
    at = _AT
    s1 = z * (at[0] + w * (at[2] + w * (at[4] + w * (at[6] + w * (
        at[8] + w * at[10])))))
    s2 = w * (at[1] + w * (at[3] + w * (at[5] + w * (at[7] + w * at[9]))))
    out = hi - ((xr * (s1 + s2) - lo) - xr)
    return torch.where(x >= 33554432.0, _ATAN_BIG, out)


def _negative(x):
    """Sign bit of x, -0.0 included, from comparisons alone (vmap has no
    batching rule for a dtype view)."""
    return (x < 0) | ((x == 0) & (1.0 / x < 0))


def atan2(y, x):
    """atan2 of finite f32 tensors (y / x not subnormal), bit for bit the
    reference's compiled code: XLA's CPU backend calls the host libm's
    atan2f, which is fdlibm's (glibc 2.36) and not correctly rounded, and
    ATen's atan2 rounds another way on ~16% of inputs. This is that
    algorithm in f32 tensor ops, so it gives the same bits on the CPU and
    on the card. (fdlibm's branches for |y / x| beyond 2**60 or below
    2**-60 give the same bits as the general path and are left out; its
    third and fourth quadrants negate its first and second exactly.)"""
    x_neg, y_neg = _negative(x), _negative(y)
    z = _atanf_nonneg(torch.abs(y / x))
    r = torch.where(x_neg, _PI - (z - _PI_LO), z)
    r = torch.where(x == 0, _PI_O_2, r)
    r = torch.where(y == 0, torch.where(x_neg, _PI, 0.0), r)
    return torch.where(y_neg, -r, r)


def fma(a, b, c):
    """a * b + c rounded once to f32, emulated in f64 (exact product)."""
    return (a.to(torch.float64) * b + c.to(torch.float64)).to(torch.float32)


def cross(ax, ay, bx, by):
    """ax * by - ay * bx, rounded as the reference's compiled f32 code
    computes it: fma(ax, by, -(ay * bx))."""
    return fma(ax, by, -(ay * bx))


def dot2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over a last axis of 2: fma(a1, b1, a0 * b0)."""
    return fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0])


def ring_mask(nvert: torch.Tensor, kv: int) -> torch.Tensor:
    """(KV,) bool mask of valid vertices."""
    return arange(kv, nvert) < nvert


def onehot_place(values: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                 out_len: int) -> torch.Tensor:
    """out[o] = values[i] where ok[i] and idx[i] == o (zeros elsewhere).

    Callers guarantee at most one contributor per output row; bool values
    OR together. Invalid or out-of-range targets land in a dropped sink row.
    values: (n,) or (n, d)."""
    v = values[:, None] if values.dim() == 1 else values
    idx = idx.long()
    valid = ok & (idx >= 0) & (idx < out_len)
    tgt = torch.where(valid, idx, out_len)
    if v.dtype == torch.bool:
        acc = torch.zeros(out_len + 1, v.shape[1], dtype=torch.int32,
                          device=v.device).index_add(0, tgt, v.to(torch.int32))
        out = acc[:out_len] > 0
    else:
        out = torch.zeros(out_len + 1, v.shape[1], dtype=v.dtype,
                          device=v.device).index_add(0, tgt, v)[:out_len]
    return out[:, 0] if values.dim() == 1 else out


def onehot_mask(idx: torch.Tensor, ok: torch.Tensor,
                out_len: int) -> torch.Tensor:
    """(out_len,) bool: True where some ok[i] has idx[i] == o."""
    return onehot_place(ok, idx, ok, out_len)


def onehot_update(old: torch.Tensor, values: torch.Tensor, idx: torch.Tensor,
                  ok: torch.Tensor) -> torch.Tensor:
    """old with rows idx[i] replaced by values[i] where ok[i]."""
    out_len = old.shape[0]
    hit = onehot_mask(idx, ok, out_len)
    placed = onehot_place(values, idx, ok, out_len).to(old.dtype)
    if old.dim() > 1:
        hit = hit.reshape((out_len,) + (1,) * (old.dim() - 1))
    return torch.where(hit, placed.reshape(old.shape), old)


def rank_compact(flags: torch.Tensor, values: torch.Tensor,
                 out_size: int) -> torch.Tensor:
    """out[j] = values[p] for the p with rank j among flagged positions;
    positions beyond the flagged count give 0. values: (n,) or (n, d)."""
    r = torch.cumsum(flags.to(torch.int64), 0) - 1
    return onehot_place(values, r, flags, out_size)


# ---------------------------------------------------------------------------
# rings
# ---------------------------------------------------------------------------

def ring_roll_indices(nvert: torch.Tensor, kv: int) -> torch.Tensor:
    """Index of each vertex's ring successor (wrapping at nvert)."""
    idx = arange(kv, nvert) + 1
    return torch.where(idx >= nvert, 0, idx)


def ring_next(x: torch.Tensor, nvert: torch.Tensor) -> torch.Tensor:
    """Successor of each ring position along axis 0, wrapping at nvert.
    Positions >= nvert hold rotated garbage; callers mask with ring_mask."""
    rolled = torch.roll(x, -1, 0)
    wrap = arange(x.shape[0], x) == nvert - 1
    w = wrap.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(w, x[0], rolled)


def ring_prev(x: torch.Tensor, nvert: torch.Tensor) -> torch.Tensor:
    """Predecessor of each ring position along axis 0 (wrap at 0)."""
    rolled = torch.roll(x, 1, 0)
    wrap = arange(x.shape[0], x) == 0
    w = wrap.reshape((-1,) + (1,) * (x.dim() - 1))
    last = take(x, torch.clamp_min(nvert - 1, 0))
    return torch.where(w, last, rolled)


def ring_signed_area(ring: torch.Tensor, nvert: torch.Tensor) -> torch.Tensor:
    # shoelace on vertex-0-centered coordinates (translation invariant)
    kv = ring.shape[0]
    m = ring_mask(nvert, kv)
    r0 = ring - ring[0]
    nxt = ring_next(r0, nvert)
    c = cross(r0[:, 0], r0[:, 1], nxt[:, 0], nxt[:, 1])
    return 0.5 * torch.where(m, c, 0.0).sum()


def ring_area(ring: torch.Tensor, nvert: torch.Tensor) -> torch.Tensor:
    """Unsigned polygon area of a masked ring buffer (KV, 2)."""
    return torch.abs(ring_signed_area(ring, nvert))


def ring_perimeter(ring: torch.Tensor, nvert: torch.Tensor) -> torch.Tensor:
    kv = ring.shape[0]
    m = ring_mask(nvert, kv)
    d = norm(ring_next(ring, nvert) - ring)
    return torch.where(m, d, 0.0).sum()


def ring_centroid(ring: torch.Tensor, nvert: torch.Tensor) -> torch.Tensor:
    """Area centroid; falls back to vertex mean for degenerate rings."""
    kv = ring.shape[0]
    m = ring_mask(nvert, kv)
    r0 = ring - ring[0]
    nxt = ring_next(r0, nvert)
    c = torch.where(m, cross(r0[:, 0], r0[:, 1], nxt[:, 0], nxt[:, 1]), 0.0)
    a = c.sum() / 2.0
    cx = ((r0[:, 0] + nxt[:, 0]) * c).sum() / 6.0
    cy = ((r0[:, 1] + nxt[:, 1]) * c).sum() / 6.0
    safe = torch.abs(a) > 1e-9
    mean = torch.where(m[:, None], ring, 0.0).sum(0) / \
        torch.clamp_min(nvert, 1)
    return torch.where(
        safe, ring[0] + torch.stack([cx, cy]) / torch.where(safe, a, 1.0),
        mean)


def ring_bounds(ring: torch.Tensor, nvert: torch.Tensor) -> torch.Tensor:
    """(4,) minx, miny, maxx, maxy over valid vertices."""
    m = ring_mask(nvert, ring.shape[0])[:, None]
    lo = torch.where(m, ring, BIG).amin(0)
    hi = torch.where(m, ring, -BIG).amax(0)
    return torch.cat([lo, hi])


def ring_segments(ring: torch.Tensor, nvert: torch.Tensor):
    """(KV, 2, 2) boundary segments + validity mask."""
    return (torch.stack([ring, ring_next(ring, nvert)], dim=1),
            ring_mask(nvert, ring.shape[0]))


# ---------------------------------------------------------------------------
# compensated arithmetic
# ---------------------------------------------------------------------------

def _two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split_f32(a):
    """Veltkamp split for f32: a == hi + lo, hi with the top 12 bits."""
    c = a * 4097.0
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    """Dekker TwoProduct: p + err == a * b exactly in f32 (no FMA)."""
    p = a * b
    ah, al = _split_f32(a)
    bh, bl = _split_f32(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def cross2_compensated(ux, uy, vx, vy):
    """ux*vy - uy*vx as a compensated f32 value (error relative to the
    result, not to the products: it matters in near-parallel cancellation)."""
    p1, e1 = _two_prod(ux, vy)
    p2, e2 = _two_prod(uy, vx)
    s, e3 = _two_sum(p1, -p2)
    return s + (e1 - e2 + e3)


# ---------------------------------------------------------------------------
# predicates
# ---------------------------------------------------------------------------

def point_segment_distance(p, a, b):
    """Broadcasted point-to-segment distance on (..., 2) tensors."""
    ab = b - a
    ap = p - a
    denom = dot2(ab, ab)
    t = torch.where(denom > 0, dot2(ap, ab) / torch.clamp_min(denom, 1e-12),
                    0.0)
    t = torch.clamp(t, 0.0, 1.0)
    proj = fma(t[..., None], ab, a)
    return norm(p - proj)


def segments_cross(p1, p2, a, b, eps: float = 1e-9):
    """Broadcasted PROPER crossing test of segments (p1, p2) and (a, b) on
    (..., 2) tensors: True when they cross at an interior point of both;
    touching at an endpoint or collinear overlap is False."""
    def cr(u, v):
        return cross(u[..., 0], u[..., 1], v[..., 0], v[..., 1])
    d1 = cr(b - a, p1 - a)
    d2 = cr(b - a, p2 - a)
    d3 = cr(p2 - p1, a - p1)
    d4 = cr(p2 - p1, b - p1)
    return (d1 * d2 < -eps) & (d3 * d4 < -eps)


def point_in_ring(p, ring, nvert):
    """Strict interior test (crossing number), bool."""
    m = ring_mask(nvert, ring.shape[0])
    a = ring
    b = ring_next(ring, nvert)
    cond = (a[:, 1] > p[1]) != (b[:, 1] > p[1])
    denom = b[:, 1] - a[:, 1]
    xin = a[:, 0] + (p[1] - a[:, 1]) * (b[:, 0] - a[:, 0]) / \
        torch.where(torch.abs(denom) > 1e-12, denom, 1.0)
    crossings = (m & cond & (p[0] < xin)).sum()
    return (crossings % 2) == 1


def dedupe_ring(ring, nvert, tol: float = 1e-7):
    """Drop consecutive near-duplicate vertices (masked compaction),
    including trailing vertices within tol of vertex 0."""
    kv = ring.shape[0]
    m = ring_mask(nvert, kv)
    pos = arange(kv, ring)
    dup = norm(ring - ring_prev(ring, nvert)) <= tol
    keep = m & (~dup | (pos == 0))
    ok = (norm(ring - ring[0]) <= tol) | ~m | ~keep
    # suffix_all[i] = all(ok[i:])
    not_ok_after = torch.flip(torch.cumsum(torch.flip(~ok, (0,)).to(torch.int64),
                                           0), (0,))
    suffix_all = not_ok_after == 0
    keep = keep & ~(suffix_all & (pos > 0))
    counts = keep.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    return onehot_place(ring, offsets, keep, kv), counts.sum()


def halfplane_clip_ring(ring, nvert, a, b, keep_left=True):
    """Sutherland–Hodgman half-plane clip on a fixed (KV, 2) buffer; a
    multi-piece result comes out as one bridged ring. keep_left: a bool or
    a bool tensor. Returns (out_ring, out_nvert, overflow)."""
    kv = ring.shape[0]
    d = b - a
    m = ring_mask(nvert, kv)
    u = ring - a
    side = cross2_compensated(d[0], d[1], u[:, 0], u[:, 1])
    if isinstance(keep_left, bool):
        side = side if keep_left else -side
    else:
        side = torch.where(keep_left, side, -side)
    side_nxt = ring_next(side, nvert)
    ring_nxt = ring_next(ring, nvert)
    keep_cur = (side >= -1e-9) & m
    crosses = (((side > 1e-9) & (side_nxt < -1e-9))
               | ((side < -1e-9) & (side_nxt > 1e-9))) & m
    t = side / torch.where(torch.abs(side - side_nxt) > 1e-12,
                           side - side_nxt, 1.0)
    cross_pt = fma(t[:, None], ring_nxt - ring, ring)
    # each input vertex emits itself (if kept), then its edge's crossing
    counts = keep_cur.to(torch.int64) + crosses.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    total = counts.sum()
    out = onehot_place(ring, offsets, keep_cur, 2 * kv) + \
        onehot_place(cross_pt, offsets + keep_cur.to(torch.int64), crosses,
                     2 * kv)
    return out[:kv], torch.clamp_max(total, kv), total > kv


def envelope_rect(points, mask):
    """Axis-aligned bounding rectangle (4, 2) of masked points."""
    m = mask[:, None]
    lo = torch.where(m, points, BIG).amin(0)
    hi = torch.where(m, points, -BIG).amax(0)
    return torch.stack([lo, torch.stack([hi[0], lo[1]]), hi,
                        torch.stack([lo[0], hi[1]])])


def clip_poly_by_convex_quad(ring, nvert, quad):
    """Clip a masked ring by a convex CCW quadrilateral.
    Returns (out_ring, out_nvert, overflow)."""
    out, n = ring, nvert
    overflow = torch.zeros((), dtype=torch.bool, device=ring.device)
    for i in range(4):
        out, n, ovf = halfplane_clip_ring(out, n, quad[i], quad[(i + 1) % 4],
                                          True)
        overflow = overflow | ovf
    out, n = dedupe_ring(out, n)
    return out, n, overflow


def difference_pieces_by_quad(ring, nvert, quad):
    """Subtract a convex quad: 4 wedge pieces (some empty), piece i = ring
    ∩ H_0 ∩ ... ∩ H_{i-1} ∩ H_iᶜ. Returns (pieces (4, KV, 2), pieces_n
    (4,), overflow)."""
    pieces_ring, pieces_n = [], []
    overflow = torch.zeros((), dtype=torch.bool, device=ring.device)
    cur, cur_n = ring, nvert
    for i in range(4):
        a, b = quad[i], quad[(i + 1) % 4]
        out_r, out_n, ovf1 = halfplane_clip_ring(cur, cur_n, a, b, False)
        out_r, out_n = dedupe_ring(out_r, out_n)
        pieces_ring.append(out_r)
        pieces_n.append(out_n)
        cur, cur_n, ovf2 = halfplane_clip_ring(cur, cur_n, a, b, True)
        cur, cur_n = dedupe_ring(cur, cur_n)
        overflow = overflow | ovf1 | ovf2
    return torch.stack(pieces_ring), torch.stack(pieces_n), overflow


def oriented_rect(a, b, depth):
    """Rectangle swept left from segment a->b by `depth` (negative sweeps
    right). CCW (4, 2)."""
    d = b - a
    nd = torch.clamp_min(norm(d), 1e-12)
    nrm = torch.stack([-d[1], d[0]]) / nd * depth
    ring = torch.stack([a, b, b + nrm, a + nrm])
    x, y = ring[:, 0], ring[:, 1]
    signed = 0.5 * (x * torch.roll(y, -1, 0) - torch.roll(x, -1, 0) * y).sum()
    return torch.where(signed >= 0, ring, torch.flip(ring, (0,)))


# ---------------------------------------------------------------------------
# convex hull, connected boolean pieces, simplification
# ---------------------------------------------------------------------------

def convex_hull_masked(pts, mask, eps: float = 1e-7):
    """Convex hull of masked points as a CCW masked ring (K, 2), nh.

    i->j is a hull edge iff every active point lies left of the line i->j
    and points collinear with it sit inside the segment span; hull vertices
    are ordered CCW by angle around their mean."""
    k = pts.shape[0]
    d = pts[None, :, :] - pts[:, None, :]             # d[i, j] = pts[j]-pts[i]
    dlen = norm(d)                                     # (K, K)
    cr = cross(d[:, :, None, 0], d[:, :, None, 1],
               d[:, None, :, 0], d[:, None, :, 1])    # (j - i) x (k - i)
    tolc = torch.maximum(eps * dlen[:, :, None],
                         32 * FLT_EPS * dlen[:, :, None] * dlen[:, None, :])
    left_ok = cr >= -tolc
    collinear = torch.abs(cr) <= tolc
    denom = torch.clamp_min(dlen * dlen, 1e-12)
    t = dot2(d[:, :, None, :], d[:, None, :, :]) / denom[:, :, None]
    span_ok = ~collinear | ((t >= -eps) & (t <= 1.0 + eps))
    idk = arange(k, pts)
    is_end = (idk[None, None, :] == idk[:, None, None]) | \
        (idk[None, None, :] == idk[None, :, None])
    pt_ok = ~mask[None, None, :] | is_end | (left_ok & span_ok)
    valid = (mask[:, None] & mask[None, :] & (dlen > eps)
             & pt_ok.all(dim=2))
    valid = valid & ~(idk[:, None] == idk[None, :])
    on_hull = valid.any(dim=1) & mask
    nh = on_hull.sum()
    c = torch.where(on_hull[:, None], pts, 0.0).sum(0) / torch.clamp_min(nh, 1)
    ang = atan2(pts[:, 1] - c[1], pts[:, 0] - c[0])
    key = torch.where(on_hull, ang, BIG)
    smaller = (key[None, :] < key[:, None]) | \
        ((key[None, :] == key[:, None]) & (idk[None, :] < idk[:, None]))
    rank = (on_hull[None, :] & smaller).sum(dim=1)
    return onehot_place(pts, rank, on_hull, k), nh


def canonicalize_ring(ring, nvert):
    """CCW orientation + rotation to the lexicographically smallest vertex
    (host Geometry.canonicalize). Returns (ring, nvert)."""
    kv = ring.shape[0]
    m = ring_mask(nvert, kv)
    pos = arange(kv, ring)
    n = torch.clamp_min(nvert, 1)
    ccw = ring_signed_area(ring, nvert) >= 0
    rev_src = torch.remainder(n - 1 - pos, n)
    src0 = torch.where(ccw, pos, rev_src)
    onehot0 = (src0[:, None] == pos[None, :]) & m[None, :] & m[:, None]
    r1 = torch.where(onehot0[:, :, None], ring[None, :, :], 0.0).sum(1)
    xkey = torch.where(m, r1[:, 0], BIG)
    minx = xkey.amin()
    cand = m & (xkey == minx)
    ykey = torch.where(cand, r1[:, 1], BIG)
    start = torch.argmin(ykey)
    src1 = torch.remainder(start + pos, n)
    onehot1 = (src1[:, None] == pos[None, :]) & m[None, :] & m[:, None]
    r2 = torch.where(onehot1[:, :, None], r1[None, :, :], 0.0).sum(1)
    return r2, nvert


def arc_pieces(ring, nvert, hull, nh, keep_inside: bool, n_pieces: int = 4,
               eps: float = 0.05, t_eps: float = 1e-3):
    """Connected pieces of ring ∩ hull (keep_inside) or ring \\ hull for a
    convex CCW hull (Weiler–Atherton in fixed shapes; see the JAX docstring
    for the construction). eps is the side-of-plane slack in grid units,
    t_eps the span slack in edge-parameter space.

    Returns (pieces (P, KV, 2), pieces_n (P,), overflow)."""
    kv = ring.shape[0]
    kh = hull.shape[0]
    m = ring_mask(nvert, kv)
    mh = ring_mask(nh, kh)
    ha = hull
    hb = ring_next(hull, nh)
    hd = hb - ha
    hlen = torch.clamp_min(norm(hd), 1e-12)
    # signed distance of each ring vertex to each hull plane (+ = inside)
    u = ring[:, None, :] - ha[None, :, :]
    f = cross2_compensated(hd[None, :, 0], hd[None, :, 1],
                           u[..., 0], u[..., 1]) / hlen[None, :]
    f = torch.where(mh[None, :], f, BIG)
    fn = ring_next(f, nvert)
    v_in = (f >= -eps).all(dim=1)
    v_in_nxt = ring_next(v_in, nvert)

    # Liang–Barsky span of each ring edge against the hull
    denom = f - fn
    tk = f / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    out_both = (f < -eps) & (fn < -eps)
    ent_k = (f < -eps) & (fn >= -eps)
    exi_k = (f >= -eps) & (fn < -eps)
    t_en = torch.where(ent_k, tk, 0.0).amax(dim=1)
    t_ex = torch.where(exi_k, tk, 1.0).amin(dim=1)
    k_en = torch.argmax(torch.where(ent_k, tk, -BIG), dim=1)
    k_ex = torch.argmin(torch.where(exi_k, tk, BIG), dim=1)
    has_span = m & ~out_both.any(dim=1) & (t_en <= t_ex + t_eps)
    nxt = ring_next(ring, nvert)
    p_en = fma(t_en[:, None], nxt - ring, ring)
    p_ex = fma(t_ex[:, None], nxt - ring, ring)
    entry = (~v_in) & has_span
    exit_ = (~v_in_nxt) & has_span

    # emission slots per edge: [vertex, entry point, exit point]
    ns = 3 * kv
    zero = torch.zeros_like(m)
    emit_v = m & (v_in if keep_inside else ~v_in)
    pos = torch.stack([ring, p_en, p_ex], dim=1).reshape(ns, 2)
    emit = torch.stack([emit_v, entry & m, exit_ & m], dim=1).reshape(ns)
    if keep_inside:
        start = torch.stack([zero, entry & m, zero], dim=1).reshape(ns)
        end = torch.stack([zero, zero, exit_ & m], dim=1).reshape(ns)
    else:
        start = torch.stack([zero, zero, exit_ & m], dim=1).reshape(ns)
        end = torch.stack([zero, entry & m, zero], dim=1).reshape(ns)
    plane = torch.stack([torch.zeros_like(k_en), k_en, k_ex],
                        dim=1).reshape(ns)

    n_runs = start.sum()
    # cyclic order starting at the first start event
    first = torch.argmax(start.to(torch.uint8))
    okey = torch.remainder(arange(ns, ring) - first, ns)
    skey = torch.where(start, okey, ns + 1)
    pid = (start[None, :] & (skey[None, :] <= okey[:, None])).sum(dim=1) - 1
    pid = torch.where(emit & (pid >= 0), pid, n_pieces + 1)
    rank = ((pid[None, :] == pid[:, None]) & (okey[None, :] < okey[:, None])
            & emit[None, :]).sum(dim=1)
    idx = arange(n_pieces, ring)
    chain_len = ((pid[:, None] == idx[None, :]) & emit[:, None]).sum(dim=0)

    def event_field(flag, val):
        onehot = flag[:, None] & (pid[:, None] == idx[None, :])
        return torch.where(onehot, val[:, None], 0).sum(dim=0)

    k_head = event_field(start, plane)
    k_tail = event_field(end, plane)
    xy_head = torch.stack([event_field(start, pos[:, 0]),
                           event_field(start, pos[:, 1])], dim=-1)
    xy_tail = torch.stack([event_field(end, pos[:, 0]),
                           event_field(end, pos[:, 1])], dim=-1)
    run_ok = idx < n_runs
    nh_s = torch.clamp_min(nh, 1)
    kt = torch.clamp(k_tail, 0, kh - 1)
    khc = torch.clamp(k_head, 0, kh - 1)

    # Weiler–Atherton run linking by arc length along the hull boundary
    plane_len = torch.where(mh, hlen, 0.0)
    cum = torch.cumsum(plane_len, 0) - plane_len
    L = torch.clamp_min(plane_len.sum(), 1e-12)
    s_tail = cum[kt] + dot2(xy_tail - ha[kt], hd[kt]) / hlen[kt]
    s_head = cum[khc] + dot2(xy_head - ha[khc], hd[khc]) / hlen[khc]
    if keep_inside:
        dmat = torch.remainder(s_head[None, :] - s_tail[:, None], L)
    else:
        dmat = torch.remainder(s_tail[:, None] - s_head[None, :], L)
    # drop degenerate zero-extent runs (a vertex exactly on the hull)
    onehot_run = (pid[:, None] == idx[None, :]) & emit[:, None]
    ext = torch.where(onehot_run,
                      norm(pos[:, None, :] - xy_head[None, :, :]),
                      0.0).amax(dim=0)
    diag = torch.diagonal(dmat)
    degenerate = run_ok & (diag <= 1e-3) & (ext <= 1e-3)
    run_ok = run_ok & ~degenerate
    dmat = torch.where(run_ok[None, :], dmat, BIG)
    # greedy unique tail->head matching in increasing arc distance
    sigma = idx
    row_done = ~run_ok
    col_used = ~run_ok
    for _ in range(n_pieces):
        cost = torch.where(row_done[:, None] | col_used[None, :], BIG, dmat)
        flat = torch.argmin(cost.reshape(-1))
        r = flat // n_pieces
        h = flat % n_pieces
        ok = cost.reshape(-1)[flat] < BIG
        sigma = torch.where(ok & (idx == r), h, sigma)
        row_done = row_done | (ok & (idx == r))
        col_used = col_used | (ok & (idx == h))

    # hull corners on the closing arc from tail(r) to head(sigma(r))
    k_head_s = k_head[sigma]
    xy_head_s = xy_head[sigma]
    s_along = dot2(xy_head_s - xy_tail, hd[kt])
    ar_kh = arange(kh, ring)
    if keep_inside:
        count = torch.remainder(k_head_s - k_tail, nh_s)
        direct = s_along >= 0
        c_idx = torch.remainder(k_tail[:, None] + 1 + ar_kh[None, :], nh_s)
    else:
        count = torch.remainder(k_tail - k_head_s, nh_s)
        direct = s_along <= 0
        c_idx = torch.remainder(k_tail[:, None] - ar_kh[None, :], nh_s)
    same = (count == 0) & ~direct
    count = torch.where(same, nh_s, count)
    pinch = norm(xy_head_s - xy_tail) <= 1e-3
    count = torch.where(pinch, 0, count)
    count = torch.where(run_ok, count, 0)

    # cycles of sigma: representative = min run index reachable
    rep = idx
    it = idx
    for _ in range(n_pieces):
        it = sigma[it]
        rep = torch.minimum(rep, it)
    run_total = chain_len + count
    off = torch.zeros_like(idx)
    cur = rep
    for _ in range(n_pieces):
        not_done = cur != idx
        off = off + torch.where(not_done, run_total[cur], 0)
        cur = torch.where(not_done, sigma[cur], cur)
    is_rep = run_ok & (rep == idx)
    piece_total = torch.where((rep[None, :] == idx[:, None]) & run_ok[None, :],
                              run_total[None, :], 0).sum(dim=1)
    pieces_n = torch.where(is_rep, piece_total, 0)

    # place subject chains and hull corners into a padded (P+2, KV+2) grid
    P2 = n_pieces + 2
    KW = kv + 2
    pid_c = torch.clamp(pid, 0, n_pieces - 1)
    sc_p = torch.where(emit & (pid < n_pieces), rep[pid_c], n_pieces + 1)
    sc_r = rank + off[pid_c]
    sc_r = torch.where(emit & (sc_r < kv), sc_r, kv + 1)
    flat1 = sc_p * KW + torch.clamp_max(sc_r, kv + 1)

    corner = take(hull, c_idx)                        # (P, KH, 2)
    c_valid = (ar_kh[None, :] < count[:, None]) & run_ok[:, None]
    c_pos = (off + chain_len)[:, None] + ar_kh[None, :]
    sc_cp = torch.where(c_valid & (c_pos < kv), c_pos, kv + 1)
    rep_b = rep[:, None].expand(sc_cp.shape)
    flat2 = rep_b.reshape(-1) * KW + torch.clamp_max(sc_cp.reshape(-1), kv + 1)

    flat = onehot_place(pos, flat1, torch.ones_like(flat1, dtype=torch.bool),
                        P2 * KW) + \
        onehot_place(corner.reshape(-1, 2), flat2,
                     torch.ones_like(flat2, dtype=torch.bool), P2 * KW)
    pieces = flat.reshape(P2, KW, 2)[:, :kv]

    overflow = (n_runs > n_pieces) | (pieces_n > kv).any()

    # no-crossing global cases
    any_out = (m & ~v_in).any()
    all_out = (~v_in | ~m).all()
    hc = torch.where(mh[:, None], hull, 0.0).sum(0) / nh_s
    hull_in_ring = point_in_ring(hc, ring, nvert)
    no_ev = n_runs == 0
    if keep_inside:
        # ring inside hull -> ring; hull inside ring -> hull; disjoint -> 0
        take_ring = no_ev & ~any_out
        take_hull = no_ev & all_out & hull_in_ring
        p0 = torch.where(take_ring, ring, pieces[0])
        hpad = torch.cat([hull, ring.new_zeros(kv - kh, 2)]) if kv > kh \
            else hull[:kv]
        p0 = torch.where(take_hull, hpad, p0)
        n0 = torch.where(take_ring, nvert,
                         torch.where(take_hull, nh, pieces_n[0]))
    else:
        # disjoint (or hull-hole) -> ring; ring inside hull -> 0 pieces
        take_ring = no_ev & any_out
        p0 = torch.where(take_ring, ring, pieces[0])
        n0 = torch.where(take_ring, nvert, pieces_n[0])
        overflow = overflow | (no_ev & any_out & hull_in_ring)
    pieces = torch.cat([p0[None], pieces[1:n_pieces]])
    pieces_n = torch.cat([n0.reshape(1).to(pieces_n.dtype),
                          pieces_n[1:n_pieces]])
    pieces, pieces_n = torch.func.vmap(dedupe_ring)(pieces, pieces_n)
    return pieces, pieces_n, overflow


def dp_simplify_ring(ring, nvert, tol):
    """Douglas–Peucker ring simplify matching the host oracle: anchored at
    the extreme vertex and the opposite mid vertex; every pass splits all
    violating chords at once, KV passes reach the fixpoint. Rings with <= 4
    vertices pass through; results below 3 vertices fall back to the input.
    Returns (out_ring, out_nvert)."""
    kv = ring.shape[0]
    m = ring_mask(nvert, kv)
    n = torch.clamp_min(nvert, 1)
    pos = arange(kv, ring)
    cmean = (torch.where(m[:, None], ring, 0.0).sum(0) + ring[0]) / (n + 1)
    dc = torch.where(m, norm(ring - cmean), -1.0)
    start = torch.argmax(dc)
    src = torch.remainder(start + pos, n)
    onehot = (src[:, None] == pos[None, :]) & m[None, :]
    rr = torch.where(onehot[:, :, None], ring[None, :, :], 0.0).sum(1)

    mid = torch.div(n + 1, 2, rounding_mode='floor')
    kept = (pos == 0) | (pos == mid)
    le = pos[None, :] <= pos[:, None]                 # j <= i
    ge = pos[None, :] >= pos[:, None]                 # j >= i
    for _ in range(kv):
        kept_m = kept & m
        # running max / min of kept positions (cummax / reversed cummin)
        pk = torch.where(le & kept_m[None, :], pos[None, :], -1).amax(dim=1)
        nk = torch.where(ge & kept_m[None, :], pos[None, :],
                         2 * kv).amin(dim=1)
        oh_a = torch.clamp(pk, 0, kv - 1)[:, None] == pos[None, :]
        a = torch.where(oh_a[:, :, None], rr[None, :, :], 0.0).sum(1)
        oh_b = torch.clamp(nk, 0, kv - 1)[:, None] == pos[None, :]
        bg = torch.where(oh_b[:, :, None], rr[None, :, :], 0.0).sum(1)
        b = torch.where((nk >= kv)[:, None], rr[0], bg)
        d = point_segment_distance(rr, a, b)
        cand = m & ~kept_m & (pos < n)
        d = torch.where(cand, d, -1.0)
        same_chord = pk[None, :] == pk[:, None]
        chord_max = torch.where(same_chord, d[None, :], -1.0).amax(dim=1)
        earlier_ge = (same_chord & (pos[None, :] < pos[:, None])
                      & (d[None, :] >= d[:, None])).any(dim=1)
        winner = cand & (d > tol) & (d >= chord_max) & ~earlier_ge
        kept = kept | winner
    kept = kept & m
    counts = kept.to(torch.int64)
    offsets = torch.cumsum(counts, 0) - counts
    out = onehot_place(rr, offsets, kept, kv)
    nkeep = counts.sum()
    out, nkeep = dedupe_ring(out, nkeep)
    passthrough = (nvert <= 4) | (nkeep < 3)
    return (torch.where(passthrough, ring, out),
            torch.where(passthrough, nvert, nkeep))


def insert_points_on_ring(ring, nvert, pts, alive, tol, max_insert: int = 8):
    """Insert alive points lying on ring edges (within tol, strictly between
    the endpoints) as new vertices, in order along each edge.
    Returns (out_ring, out_nvert, overflow)."""
    kv = ring.shape[0]
    npt = pts.shape[0]
    m = ring_mask(nvert, kv)
    a = ring
    b = ring_next(ring, nvert)
    d = point_segment_distance(pts[None, :, :], a[:, None], b[:, None])
    near_a = norm(pts[None, :, :] - a[:, None]) <= tol
    near_b = norm(pts[None, :, :] - b[:, None]) <= tol
    hit = m[:, None] & alive[None, :] & (d <= tol) & ~near_a & ~near_b
    ab = b - a
    denom = torch.clamp_min(dot2(ab, ab), 1e-12)
    t = dot2(pts[None, :, :] - a[:, None, :], ab[:, None, :]) / denom[:, None]

    flat_hit = hit.reshape(-1)
    n_ins = flat_hit.sum()
    overflow = (n_ins > max_insert) | (nvert + n_ins > kv)
    ar_kv = arange(kv, ring)
    edge_of = ar_kv[:, None].expand(kv, npt).reshape(-1)
    pos_of = pts[None, :, :].expand(kv, npt, 2).reshape(-1, 2)
    vals = torch.cat([edge_of[:, None].to(torch.float32),
                      t.reshape(-1)[:, None].to(torch.float32), pos_of], dim=1)
    cand = rank_compact(flat_hit, vals, max_insert)   # (I, 4)
    ar_i = arange(max_insert, ring)
    c_ok = ar_i < torch.clamp_max(n_ins, max_insert)
    c_edge = cand[:, 0].to(torch.int64)
    c_t = cand[:, 1]
    c_pos = cand[:, 2:4]
    # vertices shift by the candidates on earlier edges; candidates order
    # by (edge, t, slot)
    v_out = ar_kv + (c_ok[None, :] & (c_edge[None, :] < ar_kv[:, None])
                     ).sum(dim=1)
    before = (c_edge[None, :] < c_edge[:, None]) | \
        ((c_edge[None, :] == c_edge[:, None])
         & ((c_t[None, :] < c_t[:, None])
            | ((c_t[None, :] == c_t[:, None])
               & (ar_i[None, :] < ar_i[:, None]))))
    c_out = c_edge + 1 + (c_ok[None, :] & before).sum(dim=1)
    out = onehot_place(ring, v_out, m, kv) + onehot_place(c_pos, c_out, c_ok, kv)
    return out, torch.clamp_max(nvert + n_ins, kv), overflow
