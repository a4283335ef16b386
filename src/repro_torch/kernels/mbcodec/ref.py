"""Plain PyTorch versions of the mbcodec kernels.

They repeat the kernels' arithmetic in block space (``c / step``, the
carried reference, the per-step clip) and serve CPU tensors and the
kernel checks. ``want_q`` also returns the quantized coefficients, which
the checks use to count round-half flips between two float orders.
"""
from __future__ import annotations

import torch

from repro_torch.codec.codec import BITS_PER_MAG, BLOCK_OVERHEAD, RUN_BITS
from repro_torch.codec.dct import dct_tensor, qstep, weight_tensor


def _encode_step(src, qp, d, w):
    """One block transform: src (..., N, 16, 16), qp (..., N) ->
    (residual reconstruction, bits (..., N), q)."""
    c = d @ src @ d.T
    step = qstep(qp)[..., None, None] * w
    q = torch.round(c / step)
    aq = q.abs()
    bits = (BITS_PER_MAG * torch.log2(1.0 + aq)
            + RUN_BITS * (aq > 0.5).to(torch.float32)).sum(dim=(-2, -1)) \
        + BLOCK_OVERHEAD
    return d.T @ (q * step) @ d, bits, q


def mbcodec_ref(blocks: torch.Tensor, qp: torch.Tensor,
                want_q: bool = False):
    """blocks (N, 16, 16) f32, qp (N,) f32 -> (rec (N, 16, 16), bits (N,)),
    plus q (N, 16, 16) when ``want_q``."""
    d, w = dct_tensor(blocks.device), weight_tensor(blocks.device)
    rec, bits, q = _encode_step(blocks, qp, d, w)
    return (rec, bits, q) if want_q else (rec, bits)


def mbcodec_chunk_ref(blocks: torch.Tensor, qp: torch.Tensor,
                      clip_refs: bool = False, want_q: bool = False):
    """Block-space chunk scan: blocks (T, ..., N, 16, 16), qp (T, ..., N)
    -> (rec (T, ..., N, 16, 16), bits (T, ..., N)), plus q when
    ``want_q``.

    Frame t codes ``blocks[t] - ref`` and sets ``ref += rec`` (clipped to
    [0, 1] when ``clip_refs``); the frame-0 reference is zero."""
    d, w = dct_tensor(blocks.device), weight_tensor(blocks.device)
    ref = torch.zeros_like(blocks[0])
    recs, bits, qs = [], [], []
    for t in range(blocks.shape[0]):
        r, b, q = _encode_step(blocks[t] - ref, qp[t], d, w)
        ref = ref + r
        if clip_refs:
            ref = ref.clamp(0.0, 1.0)
        recs.append(ref)
        bits.append(b)
        qs.append(q)
    out = (torch.stack(recs), torch.stack(bits))
    return out + (torch.stack(qs),) if want_q else out


def rowcol_bits(cost: torch.Tensor) -> torch.Tensor:
    """A block's bits from its coefficients' costs (..., 16, 16) in the
    chunk kernel's order: thread i sums column i from row 0 down, then a
    16-lane butterfly adds the column sums at distance 8, 4, 2 and 1, and
    the header comes last."""
    col = torch.zeros_like(cost[..., 0, :])
    for k in range(16):
        col = col + cost[..., k, :]
    for half in (8, 4, 2, 1):
        col = col[..., :half] + col[..., half:2 * half]
    return col[..., 0] + BLOCK_OVERHEAD


def _forward16(x, d):
    """y[..., k] = sum_j x[..., j] D[k][j] through D's exact symmetry
    D[k][15 - j] = (-1)^k D[k][j], in the kernel's order: h[j] = x[j] +
    x[15 - j] (even k) or x[j] - x[15 - j] (odd k), then sum_{j<8} D[k][j]
    h[j], the j = 0 product first."""
    back = x.flip(-1)[..., :8]
    y = torch.empty_like(x)
    for parity, h in ((0, x[..., :8] + back), (1, x[..., :8] - back)):
        rows = d[parity::2, :8]  # (8, 8): the rows k of this parity
        s = h[..., 0:1] * rows[:, 0]
        for j in range(1, 8):
            s = s + h[..., j:j + 1] * rows[:, j]
        y[..., parity::2] = s
    return y


def _inverse16(y, d):
    """x[..., m] = sum_k y[..., k] D[k][m], in the kernel's order: e (even
    k) and o (odd k) each summed in order of k, x[m] = e + o and x[15 - m]
    = e - o for m < 8."""
    e = y[..., 0:1] * d[0, :8]
    o = y[..., 1:2] * d[1, :8]
    for k in range(2, 16, 2):
        e = e + y[..., k:k + 1] * d[k, :8]
        o = o + y[..., k + 1:k + 2] * d[k + 1, :8]
    return torch.cat([e + o, (e - o).flip(-1)], dim=-1)


def _rowcol_step(src, qp, d, w):
    """One frame of the chunk kernel's association, in its order: thread i
    of a block owns row i, then column i. src (..., 16, 16), qp (...) ->
    (residual reconstruction, bits, q). The kernel fuses each product of a
    sum into an FMA; here it is rounded apart."""
    def by_columns(f, m):
        return f(m.transpose(-1, -2), d).transpose(-1, -2)

    # row pass Y[i][k] = sum_j X[i][j] D[k][j]; column pass C[k][i] =
    # sum_j D[k][j] Y[j][i]
    coef = by_columns(_forward16, _forward16(src, d))
    step = qstep(qp)[..., None, None] * w
    q = torch.round(coef / step)
    aq = q.abs()
    cost = (BITS_PER_MAG * torch.log2(1.0 + aq)
            + torch.where(aq > 0.5, RUN_BITS, 0.0))
    bits = rowcol_bits(cost)
    # inverse column pass W[m][i] = sum_k D[k][m] deq[k][i]; inverse row
    # pass rec[i][j] = sum_m W[i][m] D[m][j]
    rec = _inverse16(by_columns(_inverse16, q * step), d)
    return rec, bits, q


def mbcodec_chunk_rowcol(blocks: torch.Tensor, qp: torch.Tensor,
                         clip_refs: bool = False, want_q: bool = False):
    """:func:`mbcodec_chunk_ref` in the chunk kernel's association: the
    forward transform as D (X D^T), a row pass then a column pass, the
    inverse as (D^T deq) D, each 16-term sum taken through D's even/odd
    symmetry as the kernel takes it, and a block's bits as per-column sums
    added by a 16-lane butterfly. Same arguments and results. The plain
    twin of ``mbcodec_chunk_kernel``: against it, only FMA rounding
    differs."""
    d, w = dct_tensor(blocks.device), weight_tensor(blocks.device)
    ref = torch.zeros_like(blocks[0])
    recs, bits, qs = [], [], []
    for t in range(blocks.shape[0]):
        r, b, q = _rowcol_step(blocks[t] - ref, qp[t], d, w)
        ref = ref + r
        if clip_refs:
            ref = ref.clamp(0.0, 1.0)
        recs.append(ref)
        bits.append(b)
        qs.append(q)
    out = (torch.stack(recs), torch.stack(bits))
    return out + (torch.stack(qs),) if want_q else out


def scores_qp(pooled: torch.Tensor, knobs: torch.Tensor, C: int):
    """The QP that ``mbcodec_chunk_scores`` assigns to each block: pooled
    (S, n_mb) dilated scores and knobs (alpha, qp_hi, qp_lo) -> (S, n_mb *
    C), ``qp_hi`` where the score reaches alpha (``>=``), in the kernels'
    flat ``(mb, C)`` block order."""
    qp = torch.where(pooled >= knobs[0], knobs[1], knobs[2])
    return qp.repeat_interleave(C, dim=-1)


def mbcodec_chunk_scores_ref(blocks: torch.Tensor, pooled: torch.Tensor,
                             knobs: torch.Tensor, C: int,
                             clip_refs: bool = False, want_q: bool = False):
    """Stream-batched chunk scan with the QP thresholded from scores:
    blocks (S, T, N, 16, 16), pooled (S, N / C), knobs (3,) -> (rec (S, T,
    N, 16, 16), bits (S, T, N)), plus q when ``want_q``. Block n of
    stream s codes at :func:`scores_qp`, then runs the scan of
    :func:`mbcodec_chunk_ref`."""
    S, T, N = blocks.shape[:3]
    qp = scores_qp(pooled, knobs, C)[None].expand(T, S, N)
    out = mbcodec_chunk_ref(blocks.transpose(0, 1), qp, clip_refs, want_q)
    return tuple(t.transpose(0, 1) for t in out)
