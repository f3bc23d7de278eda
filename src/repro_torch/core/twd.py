"""TWD — base-3 ternary weight packing (paper Sec. III-E), on tensors.

Five trits per byte (3^5 = 243 <= 256), packed along the first (input/K)
axis so that an output-axis split never cuts a byte.  Digit i of a byte is
trit 5*row + i, least significant first; digits {0, 1, 2} mean {-1, 0, +1}.
Rows appended to reach ``row_align`` hold the digit 1 five times, which
decodes to five zero trits, so a contraction over all ``5 * rows`` lanes with
zero activations past K equals the contraction over K.
"""

from __future__ import annotations

import torch

__all__ = ["TRITS_PER_BYTE", "ROW_ALIGN", "decode_lut", "packed_dim", "packed_rows",
           "pack_ternary", "unpack_ternary", "unpack_ternary_arith"]

TRITS_PER_BYTE = 5
ROW_ALIGN = 16   # packed rows of a serving export are a multiple of this
_POW3 = (1, 3, 9, 27, 81)


def decode_lut(device=None) -> torch.Tensor:
    """The (256, 5) int8 decode table: byte -> 5 trits, digit i of the byte
    in base 3 minus one; bytes >= 243 decode to zeros.  Computed on
    ``device`` itself, so a call on any device runs the same ops (no host
    table copied over)."""
    byte = torch.arange(256, dtype=torch.int32, device=device)[:, None]
    place = torch.pow(3, torch.arange(TRITS_PER_BYTE, dtype=torch.int32, device=device))
    lut = torch.div(byte, place, rounding_mode="floor") % 3 - 1
    return torch.where(byte < 3 ** TRITS_PER_BYTE, lut, 0).to(torch.int8)


def packed_dim(k: int) -> int:
    """Packed length of a K-sized axis (ceil division by 5)."""
    return (k + TRITS_PER_BYTE - 1) // TRITS_PER_BYTE


def packed_rows(k: int, row_align: int = 1) -> int:
    """Packed rows of a K-sized axis rounded up to a multiple of row_align."""
    return -(-packed_dim(k) // row_align) * row_align


def pack_ternary(values: torch.Tensor, row_align: int = 1) -> torch.Tensor:
    """int trits in {-1, 0, 1}, (K, ...) -> uint8 (packed_rows(K), ...)."""
    v = values.to(torch.int32)
    k = v.shape[0]
    rows = packed_rows(k, row_align)
    kp = rows * TRITS_PER_BYTE
    if kp != k:
        v = torch.cat([v, v.new_zeros((kp - k,) + tuple(v.shape[1:]))])
    d = (v + 1).reshape((rows, TRITS_PER_BYTE) + tuple(v.shape[1:]))
    pow3 = torch.tensor(_POW3, dtype=torch.int32, device=v.device)
    pow3 = pow3.reshape((1, TRITS_PER_BYTE) + (1,) * (v.ndim - 1))
    return (d * pow3).sum(dim=1).to(torch.uint8)


def unpack_ternary(packed: torch.Tensor, k: int) -> torch.Tensor:
    """uint8 (P, ...) -> int8 trits (k, ...), k <= 5P, by the LUT gather."""
    lut = decode_lut(packed.device)
    trits = lut[packed.long()]                    # (P, ..., 5)
    trits = torch.movedim(trits, -1, 1)           # (P, 5, ...)
    flat = trits.reshape((packed.shape[0] * TRITS_PER_BYTE,)
                         + tuple(packed.shape[1:]))
    return flat[:k].contiguous()


def unpack_ternary_arith(packed: torch.Tensor, k: int) -> torch.Tensor:
    """The same decode by repeated div/mod 3 (what the CUDA kernels do)."""
    p = packed.to(torch.int32)
    outs = []
    for _ in range(TRITS_PER_BYTE):
        outs.append(p % 3 - 1)
        p = p // 3
    trits = torch.stack(outs, dim=1)              # (P, 5, ...)
    flat = trits.reshape((packed.shape[0] * TRITS_PER_BYTE,)
                         + tuple(packed.shape[1:]))
    return flat[:k].to(torch.int8)
