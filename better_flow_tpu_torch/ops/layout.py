"""Shared data layout of the main path's kernels.

The values are those of the JAX package (``better_flow_tpu/ops/pallas/
fused_model.py`` and ``runtime/scan_pipeline.py``); the tests assert that
they are equal, and ``csrc/common.cuh`` repeats them for the CUDA sources.

Events of one slice live in chunks of ``CHUNK`` slots: ``stat`` is
(nch, 3, CHUNK) f32 [x, y, t_ns], ``act`` (nch, 1, CHUNK) f32 and the
warped positions ``pr`` (nch, 2, CHUNK) f32.  The whole optimizer state of
one slice is a (1, 32) f32 vector indexed by the ``ST_*`` slots below.
"""

from __future__ import annotations

from typing import Tuple

import torch

CHUNK = 2048        # events per chunk; a chunk's time base is its slot 0
BAND_ROWS = 36      # row-band height of the host spatial sort
PERM_SENTINEL = 0xFFFF  # u16 in-slice offset of a padding slot

# Accumulator padding of the JAX kernels (their splat window, rows x cols).
# The port keeps the same padded image so that both packages' images
# compare element for element.
RH = 128
WC = 256

ST_TDX, ST_TDY, ST_TROT, ST_TDIV = 0, 1, 2, 3       # accumulated totals
ST_CDX, ST_CDY, ST_CROT, ST_CDIV = 4, 5, 6, 7       # Kahan compensations
ST_CX, ST_CY = 8, 9                                  # event-coord centroid
ST_XDIV, ST_YDIV, ST_RDIV, ST_DDIV = 10, 11, 12, 13  # step dividers
ST_SL = 14       # slope memory[4] (rot, div, dx, dy), the cross-slice seed
ST_PD = 18       # last deltas[4]
ST_ITERS = 22
ST_CONT = 23     # 1 while the optimizer loop continues
ST_DX, ST_DY, ST_ROT, ST_DIV = 24, 25, 26, 27        # last gradient g
ST_CNT = 28
ST_FB = 29       # splat-window fallbacks of the TPU kernel; 0 in the port
ST_HAS = 30      # passed through unchanged
ST_SIZE = 32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_image_shape(H: int, W: int) -> Tuple[int, int]:
    """Padded accumulator shape (HP, WP) for logical image dims (H, W)."""
    return _round_up(max(H + 8, RH), 32), _round_up(max(W + 8, WC), 128)


def sort_key_blocks(x, y, valid, band_rows: int = 32) -> torch.Tensor:
    """Spatial sort key of the original pixels (``sort_key_blocks`` of the
    JAX package): row band major, column minor, invalid events last.
    Sorting a slice by it makes every chunk spatially local."""
    key = (x.to(torch.int32) // band_rows) * 4096 + y.to(torch.int32)
    return torch.where(valid, key, torch.full_like(key, 1 << 30))


def _chunk_rows(a: torch.Tensor) -> torch.Tensor:
    """(n,) -> (nch, 1, CHUNK) f32, zero-padded to a CHUNK multiple (at
    least one chunk)."""
    n = a.shape[0]
    n_pad = _round_up(max(n, CHUNK), CHUNK)
    out = torch.zeros(n_pad, dtype=torch.float32, device=a.device)
    out[:n] = a
    return out.reshape(n_pad // CHUNK, 1, CHUNK)


def prepare_chunk_layouts(x, y, t_ns) -> torch.Tensor:
    """The (nch, 3, CHUNK) f32 event pack [fr_x, fr_y, t_ns] of flat (n,)
    tensors, zero-padded to a CHUNK multiple (``prepare_chunk_layouts`` of
    the JAX package)."""
    return torch.cat([_chunk_rows(x), _chunk_rows(y), _chunk_rows(t_ns)],
                     dim=1)


def pack_act(active) -> torch.Tensor:
    """The (nch, 1, CHUNK) f32 activity row of a flat (n,) bool tensor,
    zero-padded to a CHUNK multiple (``pack_act`` of the JAX package)."""
    return _chunk_rows(active)
