"""Segment mean of edge embeddings onto nodes: the SGNN encoder's
aggregation (counterpart of urban_tpu/ops/pallas/segment_ops.py).

* ``segment_mean`` is the wrapper the encoder calls. On a CUDA tensor it
  launches the hand-written Hopper kernel in ``csrc/segment_mean.cu`` (the
  port of ``segment_mean_onehot_pallas``) or raises; on a CPU tensor it runs
  the plain version. ``launches`` counts the kernel launches.
* ``segment_mean_ref`` is the plain PyTorch version (counterpart of
  ``segment_mean_xla``): two ``index_add_`` passes into a sink-padded table.

Semantics shared by both: masked edges add to neither the sum nor the
count, an unmasked self-loop counts twice, endpoint indices outside
``[0, num_nodes)`` are dropped, and the divisor is ``count + 1e-6``.

The kernel library is compiled with nvcc on first use, from the sources in
this package only, into ``urban_tpu_torch/build/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

EPSILON = 1e-6
SUPPORTED_DIMS = (8, 16, 32, 64)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, 'csrc', 'segment_mean.cu')
BUILD_DIR = os.path.join(_PKG_DIR, 'build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

launches = 0          # kernel launches since the last reset
build_seconds = None  # wall time of the last nvcc build (None: cached .so)
_lib = None


def _find_nvcc() -> str:
    for cand in (os.environ.get('NVCC'), shutil.which('nvcc'),
                 '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the segment-mean kernel is built '
                       'from source and needs the CUDA toolkit')


def build_library() -> str:
    """Compile csrc/segment_mean.cu into build/ (keyed by the source hash
    and flags) unless that library already exists. Returns its path."""
    global build_seconds
    with open(_SRC, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(NVCC_FLAGS).encode())
    lib_path = os.path.join(BUILD_DIR,
                            f'libsegment_mean_{digest.hexdigest()[:12]}.so')
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{lib_path}.{os.getpid()}.tmp'
    t0 = time.perf_counter()
    proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, '-o', tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed building {_SRC}:\n{proc.stderr}')
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.segment_mean_f32.restype = ctypes.c_int
        lib.segment_mean_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        _lib = lib
    return _lib


def _check(h_edges, edges, edge_mask, num_nodes):
    if h_edges.dim() != 3:
        raise ValueError(f'h_edges must be (B, E, D), got {tuple(h_edges.shape)}')
    B, E, D = h_edges.shape
    if h_edges.dtype != torch.float32:
        raise TypeError(f'h_edges must be float32, got {h_edges.dtype}')
    if edges.dtype != torch.int32:
        raise TypeError(f'edges must be int32, got {edges.dtype}')
    if edge_mask.dtype != torch.bool:
        raise TypeError(f'edge_mask must be bool, got {edge_mask.dtype}')
    if tuple(edges.shape) != (B, E, 2):
        raise ValueError(f'edges must be {(B, E, 2)}, got {tuple(edges.shape)}')
    if tuple(edge_mask.shape) != (B, E):
        raise ValueError(
            f'edge_mask must be {(B, E)}, got {tuple(edge_mask.shape)}')
    if D not in SUPPORTED_DIMS:
        raise ValueError(f'feature width {D} not in {SUPPORTED_DIMS}')
    if int(num_nodes) <= 0:
        raise ValueError(f'num_nodes must be positive, got {num_nodes}')
    if not (h_edges.device == edges.device == edge_mask.device):
        raise ValueError('h_edges, edges and edge_mask must share a device')
    for name, t in (('h_edges', h_edges), ('edges', edges),
                    ('edge_mask', edge_mask)):
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')


def segment_mean_ref(h_edges: torch.Tensor, edges: torch.Tensor,
                     edge_mask: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Plain PyTorch segment mean: (B, E, D), (B, E, 2), (B, E) -> (B, N, D)."""
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
    return out.reshape(B, N, D)


def segment_mean(h_edges: torch.Tensor, edges: torch.Tensor,
                 edge_mask: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Scatter-mean edge embeddings to their endpoint nodes.

    h_edges (B, E, D) float32, edges (B, E, 2) int32, edge_mask (B, E) bool,
    all contiguous on one device; D in SUPPORTED_DIMS. Returns (B, N, D)
    float32. CUDA tensors run the kernel; CPU tensors the plain version."""
    global launches
    _check(h_edges, edges, edge_mask, num_nodes)
    dev = h_edges.device
    if dev.type == 'cpu':
        return segment_mean_ref(h_edges, edges, edge_mask, num_nodes)
    if dev.type != 'cuda':
        raise ValueError(f'segment_mean runs on cpu or cuda, not {dev}')
    B, E, D = h_edges.shape
    lib = load_library()
    out = torch.empty((B, int(num_nodes), D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.segment_mean_f32(h_edges.data_ptr(), edges.data_ptr(),
                                  edge_mask.data_ptr(), out.data_ptr(),
                                  B, E, int(num_nodes), D, stream)
    if rc != 0:
        raise RuntimeError(f'segment_mean kernel launch failed: CUDA error {rc}')
    launches += 1
    return out
