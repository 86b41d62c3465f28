"""Segment mean of edge embeddings onto nodes: the SGNN encoder's
aggregation (counterpart of urban_tpu/ops/pallas/segment_ops.py), with its
gradient.

* ``segment_mean`` is the wrapper the encoder calls. Where autograd needs a
  gradient (grad mode on and ``h_edges.requires_grad``) it goes through
  ``SegmentMean``; otherwise (rollout, collect, eval) it runs
  ``segment_mean_counts`` and drops the counts.
* ``segment_mean_counts`` returns the mean and the per-node counts through
  the forward kernel ``csrc/segment_mean.cu``, the port of both Pallas
  kernels (``segment_mean_pallas`` and ``segment_mean_onehot_pallas``),
  launched with the split of each batch element over CTAs, the block size
  and the shared memory that ``forward_plan`` chooses from the card's SM
  count and shared-memory limits (``device_limits``); a graph whose CSR
  does not fit one CTA's shared memory, or whose keys pass 16 bits, takes
  the general plan, whose CSR lives in device memory
  (``forward_scratch_words`` of scratch, allocated here).
* ``SegmentMean`` is the autograd function: its forward is
  ``segment_mean_counts``, its backward ``segment_mean_backward``
  (``csrc/segment_mean_backward.cu``, no TPU counterpart), launched with
  the column tile, shared memory and block size that ``backward_plan``
  chooses.
* Each wrapper launches its hand-written Hopper kernel on a CUDA tensor (or
  raises) and runs its plain PyTorch version on a CPU tensor:
  ``segment_mean_ref`` / ``segment_mean_counts_ref`` (counterparts of
  ``segment_mean_xla``: two ``index_add_`` passes into a sink-padded table)
  and ``segment_mean_backward_ref``. ``launches`` counts the kernel
  launches, one entry per kernel.

An empty batch (B = 0, a data-parallel rank without rows in a minibatch)
or graph (E = 0) gives zeros of the right shape without a launch.

Semantics shared by all: masked edges add to neither the sum nor the count
(and get a zero gradient row), an unmasked self-loop counts twice, endpoint
indices outside ``[0, num_nodes)`` are dropped, and the divisor is
``count + 1e-6``. Any graph and any width D >= 1, as the JAX package's
aggregation: widths in ``TEMPLATED_DIMS`` have their own instantiations in
the kernels, any other width a runtime-width one.

Each kernel library is compiled with nvcc on first use, from the sources in
this package only, into ``urban_tpu_torch/build/``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, NamedTuple, Tuple

import torch
from torch.autograd.function import once_differentiable

EPSILON = 1e-6
# the widths with their own instantiations in both kernels; every other
# width D >= 1 runs a runtime-width one
TEMPLATED_DIMS = (8, 16, 32, 64)


class DeviceLimits(NamedTuple):
    """What the launch plans read of a card: its SMs, the shared memory one
    block may opt in to, and an SM's shared memory; the difference of the
    last two is what the runtime reserves per resident block."""
    num_sms: int
    shared_bytes_per_block: int
    shared_bytes_per_sm: int

    @property
    def reserved_bytes(self) -> int:
        return self.shared_bytes_per_sm - self.shared_bytes_per_block


# the H100 SXM's limits: the plans' default where no card is named
H100_SXM = DeviceLimits(132, 232448, 233472)
NUM_SMS, SHARED_BYTES_PER_BLOCK, SHARED_BYTES_PER_SM = H100_SXM
SHARED_BYTES_RESERVED = H100_SXM.reserved_bytes


def limits_of(props) -> DeviceLimits:
    """The limits in a card's torch.cuda.get_device_properties."""
    return DeviceLimits(int(props.multi_processor_count),
                        int(props.shared_memory_per_block_optin),
                        int(props.shared_memory_per_multiprocessor))


@functools.lru_cache(maxsize=None)
def device_limits(device: torch.device) -> DeviceLimits:
    """The limits of the CUDA device `device`, read once."""
    return limits_of(torch.cuda.get_device_properties(device))

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(_PKG_DIR, 'build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# kernel -> (source in csrc/, {exported C function: argtypes})
KERNELS = {
    'segment_mean': ('segment_mean.cu', {
        'segment_mean_f32': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
        'segment_mean_general_f32': [_P, _P, _P, _P, _P, _P, _L, _I, _I,
                                     _I, _I, _P],
        'segment_mean_resident': [_I, _I, _I, _I]}),
    'segment_mean_backward': ('segment_mean_backward.cu', {
        'segment_mean_backward_f32': [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _I, _P]}),
}

launches = dict.fromkeys(KERNELS, 0)   # kernel launches since the last reset
build_seconds = {}   # kernel -> wall time of its last nvcc build (absent: cached)
_libs = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _find_nvcc() -> str:
    for cand in (os.environ.get('NVCC'), shutil.which('nvcc'),
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the segment-mean kernels are built '
                       'from source and need the CUDA toolkit')


def library_path(name: str) -> Tuple[str, str]:
    """(source, library) of a kernel; the library name carries the hash of
    the source and the flags."""
    src = os.path.join(_CSRC, KERNELS[name][0])
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f'lib{name}_{digest.hexdigest()[:12]}.so')


def build_libraries(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, str]:
    """Compile every named kernel whose library is not built yet, one nvcc
    per source, all started together, and wait for all of them. Returns
    {kernel: library path}; raises after every build has ended if any
    failed."""
    paths, procs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        src, path = library_path(name)
        paths[name] = path
        if os.path.exists(path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f'{path}.{os.getpid()}.tmp'
        procs[name] = (subprocess.Popen(
            [_find_nvcc(), *NVCC_FLAGS, '-o', tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            src, tmp, path)
    errors = []
    for name, (proc, src, tmp, path) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f'nvcc failed building {src}:\n{err}')
            continue
        os.replace(tmp, path)
        build_seconds[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError('\n'.join(errors))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(build_libraries([name])[name])
        for fn, argtypes in KERNELS[name][1].items():
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
    return _libs[name]


def _launch(name: str, fn: str, *args) -> None:
    lib = load_library(name)
    rc = getattr(lib, fn)(*args)
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {rc}')
    launches[name] += 1


def _device(t: torch.Tensor) -> torch.device:
    if t.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'segment-mean kernels run on cpu or cuda, '
                         f'not {t.device}')
    return t.device


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_features(name, t, shape_doc):
    if t.dim() != 3:
        raise ValueError(f'{name} must be {shape_doc}, got {tuple(t.shape)}')
    if t.dtype != torch.float32:
        raise TypeError(f'{name} must be float32, got {t.dtype}')
    if t.shape[-1] < 1:
        raise ValueError(f'feature width must be at least 1, got '
                         f'{t.shape[-1]}')


def _vector_width(width: int) -> bool:
    """Whether the kernels read and write rows of this width as float4
    (every D % 4 == 0), which needs 16-byte aligned rows; other widths take
    scalar loads."""
    return width % 4 == 0


def _check_graph(edges, edge_mask, B, E, num_nodes, like):
    if edges.dtype != torch.int32:
        raise TypeError(f'edges must be int32, got {edges.dtype}')
    if edge_mask.dtype != torch.bool:
        raise TypeError(f'edge_mask must be bool, got {edge_mask.dtype}')
    if tuple(edges.shape) != (B, E, 2):
        raise ValueError(f'edges must be {(B, E, 2)}, got {tuple(edges.shape)}')
    if tuple(edge_mask.shape) != (B, E):
        raise ValueError(
            f'edge_mask must be {(B, E)}, got {tuple(edge_mask.shape)}')
    if int(num_nodes) <= 0:
        raise ValueError(f'num_nodes must be positive, got {num_nodes}')
    if not (like.device == edges.device == edge_mask.device):
        raise ValueError('all tensors must share a device')
    for name, t in (('edges', edges), ('edge_mask', edge_mask)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def _check(h_edges, edges, edge_mask, num_nodes):
    _check_features('h_edges', h_edges, '(B, E, D)')
    B, E, _ = h_edges.shape
    _check_graph(edges, edge_mask, B, E, num_nodes, h_edges)
    if not h_edges.is_contiguous():
        raise ValueError('h_edges must be contiguous')


class ForwardPlan(NamedTuple):
    """Launch of csrc/segment_mean.cu: each batch element's nodes split
    over `split` CTAs (one thread-block cluster where split > 1) of
    `threads` threads, each with `shared_bytes` of shared memory; where
    `staged`, one CTA an element first copies the element's rows of h into
    shared memory (one bulk copy, while it builds its CSR) and gathers from
    there, else the gather reads the rows from global memory. The kernel
    runs D's own instantiation where D is in TEMPLATED_DIMS and the
    runtime-width one else; `any_width` runs the runtime-width one at every
    D (an override: kernel_bench times the two).

    `general`: the general plan instead (segment_mean_general_f32), for a
    graph the shared-memory plans do not take: the CSR in device memory
    (forward_scratch_words of scratch), seven launches; `threads` and
    `shared_bytes` say what the kernel file's own constants are (the
    gather's block size, the hub sort's buffer), for reports."""
    split: int
    threads: int
    staged: bool
    shared_bytes: int
    general: bool = False
    any_width: bool = False


FORWARD_SPLITS = (1, 2, 4, 8)
FORWARD_THREADS = (512, 1024)
FORWARD_STATIC_BYTES = 16   # the kernel's static shared memory (an mbarrier)
# the general plan's constants (csrc/segment_mean.cu kGeneralThreads,
# kHubBytes): the gather's block size and the hub sort's shared memory
# (8192 keys), for forward_shared_bytes and reports
GENERAL_THREADS, GENERAL_SHARED_BYTES = 256, 8192 * 4


def forward_shared_bytes(num_nodes: int, num_edges: int, width: int,
                         split: int, threads: int, staged: bool,
                         general: bool = False) -> int:
    """Dynamic shared memory of one CTA of the forward kernel (shared_bytes
    in csrc/segment_mean.cu): where staged, E rows of D floats; then a word
    a warp and a word a node of its range, 16-bit bucket starts, 2 E keys
    and E local endpoints of each kind. The general plan's CTAs hold no
    CSR: its hub sort's buffer, whatever the graph."""
    if general:
        return GENERAL_SHARED_BYTES
    m = -(-int(num_nodes) // split)
    size = (int(num_edges) * width * 4 if staged else 0) + \
        4 * (threads // 32 + m) + 2 * (m + 1 + 4 * int(num_edges))
    return -(-size // 16) * 16


def forward_scratch_words(batch: int, num_nodes: int, num_edges: int) -> int:
    """int32 words of device memory the general plan's CSR takes
    (scratch_words in csrc/segment_mean.cu): each node's entry counter, each
    element's N + 1 bucket starts and its 2 E bucket keys."""
    b, n, e = int(batch), int(num_nodes), int(num_edges)
    return b * n + b * (n + 1) + 2 * b * e


def _fits(size: int, limits: DeviceLimits) -> bool:
    return size + FORWARD_STATIC_BYTES <= limits.shared_bytes_per_block


def general_plan() -> ForwardPlan:
    """The general plan: the CSR in device memory, for any graph."""
    return ForwardPlan(1, GENERAL_THREADS, False, GENERAL_SHARED_BYTES,
                       general=True)


@functools.lru_cache(maxsize=None)
def forward_plan(batch: int, num_nodes: int, num_edges: int, width: int,
                 limits: DeviceLimits = H100_SXM) -> ForwardPlan:
    """The forward kernel's launch plan for B batch elements of N nodes, E
    edges and D columns on a card of `limits` (the wrapper passes its
    tensor's device_limits). The shared-memory plans take a graph where one
    CTA of 1024 threads holds its CSR (at least every graph the kernel
    before these plans took) and its keys 2 e + 1 fit 16 bits; every other
    graph takes the general plan (general_plan). Where the batch fills the
    card (B > its SMs) and the element's rows of h fit beside its CSR (and
    D % 4 == 0, for the bulk copy), each element is staged in one CTA of
    1024 threads, so that h is read once, in order, while the CSR is built.
    Else the gather reads h from global memory: with 1024 threads and the
    largest split of 8, 4, 2 or 1 CTAs an element that keeps the batch in
    one wave of a CTA an SM, or, past the SMs, with two CTAs of 512 threads
    an element, two an SM (faster at B 256 than one CTA an element in one
    wave: kernel_bench's plan sweep times every plan). Any width: the
    kernel picks its instantiation by D. Raises ValueError only for
    invalid inputs: N < 1, E < 0 or D < 1."""
    n, e, b, d = int(num_nodes), int(num_edges), int(batch), int(width)
    if n <= 0 or e < 0 or d <= 0:
        raise ValueError(f'segment_mean: no plan for {n} nodes, {e} edges '
                         f'and width {d}')
    if 2 * e + 1 > 0xFFFF or not _fits(
            forward_shared_bytes(n, e, d, 1, 1024, False), limits):
        return general_plan()
    staged = forward_shared_bytes(n, e, d, 1, 1024, True)
    if b > limits.num_sms and _vector_width(d) and _fits(staged, limits):
        return ForwardPlan(1, 1024, True, staged)
    for split in FORWARD_SPLITS[::-1]:   # each fits where split 1 does
        if b * split <= limits.num_sms:
            return ForwardPlan(split, 1024, False, forward_shared_bytes(
                n, e, d, split, 1024, False))
    return ForwardPlan(2, 512, False,
                       forward_shared_bytes(n, e, d, 2, 512, False))


class BackwardPlan(NamedTuple):
    """Launch of csrc/segment_mean_backward.cu: each block of `threads`
    threads stages `tile` columns of every node row in `shared_bytes` of
    shared memory; 0 bytes is the gather path (full rows read from device
    memory)."""
    tile: int
    shared_bytes: int
    threads: int


def backward_plan(num_nodes: int, width: int,
                  limits: DeviceLimits = H100_SXM) -> BackwardPlan:
    """The backward kernel's column tile, shared memory and block size for
    N nodes of D columns on a card of `limits` (the wrapper passes its
    tensor's device_limits). Tiles are multiples of 4 columns (float4)
    dividing D. First choice: the widest tile of at least 8 columns (whole
    32-byte sectors of a dh row per block) with which two blocks of 512
    threads share an SM; else the widest tile one block of 1024 threads can
    hold; else, where not even 4 columns of N rows fit or D has no such
    divisor (D % 4 != 0), the gather path, also with 1024 threads (its own
    instantiation for D in TEMPLATED_DIMS, else the runtime-width one;
    kernel_bench's tile sweep times the others)."""
    n = int(num_nodes)
    tiles = [t for t in (64, 32, 16, 8, 4) if t <= width and width % t == 0]
    two_per_sm = limits.shared_bytes_per_sm // 2 - limits.reserved_bytes
    for t in tiles:
        if t >= 8 and n * t * 4 <= two_per_sm:
            return BackwardPlan(t, n * t * 4, 512)
    for t in tiles:
        if n * t * 4 <= limits.shared_bytes_per_block:
            return BackwardPlan(t, n * t * 4, 1024)
    return BackwardPlan(width, 0, 1024)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def segment_mean_counts_ref(h_edges: torch.Tensor, edges: torch.Tensor,
                            edge_mask: torch.Tensor, num_nodes: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch segment mean and per-node counts: (B, E, D), (B, E, 2),
    (B, E) -> (B, N, D), (B, N). Differentiable in h_edges."""
    B, E, D = h_edges.shape
    N = int(num_nodes)
    dev = h_edges.device
    ed = edges.long()
    valid = edge_mask[..., None] & (ed >= 0) & (ed < N)
    base = (torch.arange(B, device=dev) * N)[:, None, None]
    idx = torch.where(valid, ed + base, B * N)          # B * N = sink row
    h = h_edges.reshape(B * E, D).to(torch.float32)
    ones = torch.ones(B * E, dtype=torch.float32, device=dev)
    s = torch.zeros(B * N + 1, D, dtype=torch.float32, device=dev)
    c = torch.zeros(B * N + 1, dtype=torch.float32, device=dev)
    for k in (0, 1):
        s.index_add_(0, idx[..., k].reshape(-1), h)
        c.index_add_(0, idx[..., k].reshape(-1), ones)
    out = s[:-1] / (c[:-1, None] + EPSILON)
    return out.reshape(B, N, D), c[:-1].reshape(B, N)


def segment_mean_ref(h_edges: torch.Tensor, edges: torch.Tensor,
                     edge_mask: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Plain PyTorch segment mean: (B, E, D), (B, E, 2), (B, E) -> (B, N, D)."""
    return segment_mean_counts_ref(h_edges, edges, edge_mask, num_nodes)[0]


def segment_mean_backward_ref(grad_out: torch.Tensor, counts: torch.Tensor,
                              edges: torch.Tensor, edge_mask: torch.Tensor
                              ) -> torch.Tensor:
    """Plain PyTorch gradient of the segment mean in h_edges: (B, N, D)
    gradient of the mean, (B, N) counts -> (B, E, D)."""
    B, N, D = grad_out.shape
    ed = edges.long()
    keep = edge_mask[..., None] & (ed >= 0) & (ed < N)   # (B, E, 2)
    scaled = grad_out / (counts[..., None] + EPSILON)
    idx = ed.clamp(0, N - 1)
    gu = torch.gather(scaled, 1, idx[..., 0:1].expand(-1, -1, D))
    gv = torch.gather(scaled, 1, idx[..., 1:2].expand(-1, -1, D))
    return (torch.where(keep[..., 0:1], gu, 0.0)
            + torch.where(keep[..., 1:2], gv, 0.0))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def segment_mean_counts(h_edges: torch.Tensor, edges: torch.Tensor,
                        edge_mask: torch.Tensor, num_nodes: int,
                        plan: ForwardPlan = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment mean (B, N, D) and per-node counts (B, N), without a
    gradient. CUDA tensors run csrc/segment_mean.cu with `plan` (default:
    forward_plan's for the tensor's card; kernel_bench times the others),
    the general plan with its scratch allocated here on the tensor's
    device; CPU tensors the plain version."""
    _check(h_edges, edges, edge_mask, num_nodes)
    dev = _device(h_edges)
    N = int(num_nodes)
    B, E, D = h_edges.shape
    if B == 0 or E == 0:   # no rows (a data-parallel rank's share) or edges
        return (h_edges.new_zeros((B, N, D)), h_edges.new_zeros((B, N)))
    if dev.type == 'cpu':
        with torch.no_grad():
            return segment_mean_counts_ref(h_edges, edges, edge_mask, N)
    if (_vector_width(D) and h_edges.data_ptr() % 16) or edges.data_ptr() % 8:
        raise ValueError('segment_mean: h_edges must be 16-byte (D % 4 == 0) '
                         'and edges 8-byte aligned')
    plan = plan or forward_plan(B, N, E, D, device_limits(dev))
    with torch.cuda.device(dev):
        out = torch.empty((B, N, D), dtype=torch.float32, device=dev)
        counts = torch.empty((B, N), dtype=torch.float32, device=dev)
        pointers = (h_edges.data_ptr(), edges.data_ptr(),
                    edge_mask.data_ptr(), out.data_ptr(), counts.data_ptr())
        if plan.general:
            words = forward_scratch_words(B, N, E)
            scratch = torch.empty(words, dtype=torch.int32, device=dev)
            _launch('segment_mean', 'segment_mean_general_f32', *pointers,
                    scratch.data_ptr(), words, B, E, N, D, _stream(dev))
        else:
            _launch('segment_mean', 'segment_mean_f32', *pointers, B, E, N,
                    D, plan.split, plan.threads, int(plan.staged),
                    int(plan.any_width), plan.shared_bytes, _stream(dev))
    return out, counts


def segment_mean_backward(grad_out: torch.Tensor, counts: torch.Tensor,
                          edges: torch.Tensor, edge_mask: torch.Tensor,
                          plan: BackwardPlan = None) -> torch.Tensor:
    """Gradient of the segment mean in h_edges: the backward of
    SegmentMean. CUDA tensors run csrc/segment_mean_backward.cu with
    `plan` (default: backward_plan's for the tensor's card; kernel_bench
    times the others), CPU tensors the plain version. Both take the same
    inputs: grad_out must be 16-byte aligned where D % 4 == 0 (float4
    rows), and edges 8-byte aligned."""
    _check_features('grad_out', grad_out, '(B, N, D)')
    B, N, D = grad_out.shape
    E = edge_mask.shape[-1]
    _check_graph(edges, edge_mask, B, E, N, grad_out)
    if counts.dtype != torch.float32:
        raise TypeError(f'counts must be float32, got {counts.dtype}')
    if tuple(counts.shape) != (B, N):
        raise ValueError(f'counts must be {(B, N)}, got {tuple(counts.shape)}')
    if counts.device != grad_out.device:
        raise ValueError('all tensors must share a device')
    if not (grad_out.is_contiguous() and counts.is_contiguous()):
        raise ValueError('grad_out and counts must be contiguous')
    if B == 0 or E == 0:
        return grad_out.new_zeros((B, E, D))
    vector = _vector_width(D)
    if (vector and grad_out.data_ptr() % 16) or edges.data_ptr() % 8:
        raise ValueError('segment_mean_backward: grad_out must be 16-byte '
                         '(D % 4 == 0) and edges 8-byte aligned')
    dev = _device(grad_out)
    if dev.type == 'cpu':
        return segment_mean_backward_ref(grad_out, counts, edges, edge_mask)
    dh = torch.empty((B, E, D), dtype=torch.float32, device=dev)
    if vector and dh.data_ptr() % 16:
        raise ValueError('segment_mean_backward: dh is not 16-byte aligned')
    plan = plan or backward_plan(N, D, device_limits(dev))
    with torch.cuda.device(dev):
        _launch('segment_mean_backward', 'segment_mean_backward_f32',
                grad_out.data_ptr(), counts.data_ptr(), edges.data_ptr(),
                edge_mask.data_ptr(), dh.data_ptr(), B, E, N, D, *plan,
                _stream(dev))
    return dh


class SegmentMean(torch.autograd.Function):
    """Segment mean with a gradient in h_edges: forward segment_mean_counts,
    backward segment_mean_backward (kernels on CUDA, plain versions on the
    CPU)."""

    @staticmethod
    def forward(ctx, h_edges, edges, edge_mask, num_nodes):
        out, counts = segment_mean_counts(h_edges, edges, edge_mask,
                                          num_nodes)
        ctx.save_for_backward(edges, edge_mask, counts)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        edges, edge_mask, counts = ctx.saved_tensors
        dh = segment_mean_backward(grad_out.contiguous(), counts, edges,
                                   edge_mask)
        return dh, None, None, None


def segment_mean(h_edges: torch.Tensor, edges: torch.Tensor,
                 edge_mask: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Scatter-mean edge embeddings to their endpoint nodes.

    h_edges (B, E, D) float32, edges (B, E, 2) int32, edge_mask (B, E) bool,
    all contiguous on one device; any E >= 0, N >= 1, D >= 1. Returns (B, N, D)
    float32, with a grad_fn where h_edges requires a gradient (SegmentMean).
    Without one, CUDA tensors run the forward kernel and CPU tensors the
    plain version."""
    if torch.is_grad_enabled() and h_edges.requires_grad:
        return SegmentMean.apply(h_edges, edges, edge_mask, int(num_nodes))
    return segment_mean_counts(h_edges, edges, edge_mask, num_nodes)[0]
