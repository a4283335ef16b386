"""Plain PyTorch versions of the RWKV6 WKV recurrence.

- :func:`wkv6_ref`: the token-by-token oracle (port of
  ``repro/kernels/wkv6/ref.py``).
- :func:`wkv_chunked`: the chunked form of the reference model (port of
  ``repro/models/rwkv6.py::wkv_chunked``), in its float order. CPU tensors
  take it, so that the port's model on the CPU sums as the reference's
  does; the kernel checks compare with it at full size.
- :func:`wkv6_segmented`: the decomposition that the CUDA kernel
  (``csrc/wkv6.cu``) computes, written plainly: the sequence cut into
  segments, each with its local state, chained in a fixed order, and
  chunks cut into sub-blocks. :func:`segment_plan` is the wrapper's
  choice of segments. Tests use it; the serving path does not.

Both take r, k, v and log_decay (B, S, H, hd), u (H, hd) and the state s0
(B, H, hd, hd), which maps a k channel to a v channel, and return
(o (B, S, H, hd), final state), in fp32.
"""
from __future__ import annotations

import torch

from repro_torch import loop

WKV_CHUNK = 32  # the reference model's chunk
# the CUDA kernel's decomposition (csrc/wkv6.cu: C, SB, TS, MAX_SEG)
SEG_CHUNK = 16     # tokens per chunk
SEG_SUB = 8        # tokens per sub-block of a chunk
MAX_SEG_LEN = 128  # tokens per segment at most (its tiles in shared memory)
MAX_SEGMENTS = 8   # segments per (b, h): the portable cluster size


def wkv6_ref(r, k, v, log_decay, u, s0):
    """o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);
    S_t = diag(e^ld_t) S_{t-1} + k_t v_t^T."""
    s = s0.float()
    bonus_u = u.float()[None]
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, lt = (x[:, t].float() for x in (r, k, v, log_decay))
        o = torch.einsum("bhd,bhde->bhe", rt, s) + \
            torch.einsum("bhd,bhd,bhe->bhe", rt, bonus_u * kt, vt)
        s = s * torch.exp(lt)[..., None] + torch.einsum("bhd,bhe->bhde", kt,
                                                        vt)
        outs.append(o)
    return torch.stack(outs, dim=1), s


def _chunk_len(S: int, chunk: int) -> int:
    """The reference's choice: ``chunk`` when it divides S (or S itself
    when shorter), else 1."""
    c = min(chunk, S)
    if S % c != 0:
        c = 1 if S % chunk else chunk
        while S % c != 0:
            c -= 1
    return c


def wkv_chunked(r, k, v, log_decay, u, s0, chunk: int = WKV_CHUNK):
    """Chunked-parallel WKV6 in the reference's float order. The pairwise
    decays inside a chunk are exp(Lx[t] - L[s]), kept for s < t: the
    exponent is masked to 0 at s >= t before the exponential, where the
    reference takes it for every pair and masks after. The kept entries
    are the same bits; the masked ones, which grow without bound for fast
    decays, no longer overflow, so the gradients stay finite."""
    B, S, H, hd = r.shape
    c = _chunk_len(S, chunk)
    n = S // c
    f32 = torch.float32

    def reshape_c(x):
        return x.to(f32).reshape(B, n, c, H, hd).transpose(0, 1)

    rc, kc, vc, ldc = map(reshape_c, (r, k, v, log_decay))
    u = u.to(f32)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)

    def one(chunk, s):
        rb, kb, vb, lb = chunk  # (B, c, H, hd)
        L = torch.cumsum(lb, dim=1)  # inclusive
        Lx = L - lb  # exclusive
        expo = torch.where(tri[None, :, :, None, None],
                           Lx[:, :, None] - L[:, None, :], 0.0)
        decay = torch.exp(expo)  # (B, t, s, H, hd)
        A = torch.einsum("bthd,btshd->bhts", rb, kb[:, None] * decay)
        A = torch.where(tri[None, None], A, torch.zeros_like(A))
        o = torch.einsum("bhts,bshd->bthd", A, vb)
        diag = torch.einsum("bthd,bthd->bth", rb, kb * u[None, None])
        o = o + diag[..., None] * vb
        o = o + torch.einsum("bthd,bhde->bthe", rb * torch.exp(Lx), s)
        Lc = L[:, -1]  # (B, H, hd)
        kd = kb * torch.exp(Lc[:, None] - L)
        s = s * torch.exp(Lc)[..., None] + torch.einsum("bshd,bshe->bhde",
                                                        kd, vb)
        return o, s

    outs, s = loop(one, zip(rc, kc, vc, ldc), s0.to(f32))
    o = torch.stack(outs, dim=1).reshape(B, S, H, hd)
    return o, s


def segment_plan(S: int, n_seg: int | None = None):
    """(segments, tokens per segment, rounds) for a sequence of S tokens.

    Segments are whole chunks, at most :data:`MAX_SEG_LEN` tokens, and as
    few as cover S in one round, up to :data:`MAX_SEGMENTS` (or
    ``n_seg``). A longer sequence takes several rounds of ``segments``
    segments each; the last segment of a round may be short or empty."""
    if S < 1:
        raise ValueError(f"empty sequence: S={S}")
    want = MAX_SEGMENTS if n_seg is None else n_seg
    if not 1 <= want <= MAX_SEGMENTS:
        raise ValueError(f"segments must lie in 1..{MAX_SEGMENTS}, got "
                         f"{n_seg}")
    per = -(-S // want)
    seg_len = min(MAX_SEG_LEN, -(-per // SEG_CHUNK) * SEG_CHUNK)
    segments = min(want, -(-S // seg_len))
    return segments, seg_len, -(-S // (segments * seg_len))


def _chunk_step(rb, kb, vb, lb, u, s, sub):
    """One chunk (B, n, H, hd) from the state ``s`` at its start -> (o,
    state at its end). L is the inclusive cumulative log-decay from the
    chunk's start, Lx[t] = L[t-1] (0 at t = 0); every exponent is <= 0.
    Pairs s < t in one sub-block take exp(Lx[t] - L[s]) each; a pair in
    an earlier sub-block factorises about L_ref, the L of that sub-block's
    last token: (r exp(Lx - L_ref)) . (k exp(L_ref - L))."""
    n = rb.shape[1]
    L = torch.cumsum(lb, dim=1)
    Lx = torch.cat([torch.zeros_like(L[:, :1]), L[:, :-1]], dim=1)
    A = rb.new_zeros(rb.shape[0], rb.shape[2], n, n)  # (B, H, t, s)
    for s0_ in range(0, n, sub):
        s1 = min(s0_ + sub, n)
        idx = torch.arange(s0_, s1)
        below = idx[:, None] > idx[None, :]  # s < t
        expo = Lx[:, s0_:s1, None] - L[:, None, s0_:s1]  # (B, t, s, H, hd)
        expo = torch.where(below[None, :, :, None, None], expo,
                           torch.zeros_like(expo))
        pair = torch.einsum("bthd,bshd,btshd->bhts", rb[:, s0_:s1],
                            kb[:, s0_:s1], torch.exp(expo))
        A[:, :, s0_:s1, s0_:s1] = pair * below
        if s1 < n:  # every later token against this sub-block
            L_ref = L[:, s1 - 1:s1]
            rh = rb[:, s1:] * torch.exp(Lx[:, s1:] - L_ref)
            kh = kb[:, s0_:s1] * torch.exp(L_ref - L[:, s0_:s1])
            A[:, :, s1:, s0_:s1] = torch.einsum("bthd,bshd->bhts", rh, kh)
    diag = torch.einsum("bthd,bthd->bht", rb, kb * u[None, None])
    A = A + torch.diag_embed(diag)
    o = torch.einsum("bhts,bshd->bthd", A, vb)
    o = o + torch.einsum("bthd,bhde->bthe", rb * torch.exp(Lx), s)
    Lc = L[:, -1]
    kd = kb * torch.exp(Lc[:, None] - L)
    s = s * torch.exp(Lc)[..., None] + torch.einsum("bshd,bshe->bhde", kd,
                                                    vb)
    return o, s


def _segment_delta(kb, vb, lb, chunk):
    """A segment's local state from zero and its decay, as the kernel forms
    them: ds = sum_c diag(Ea[c]) K~_c^T V_c with Ea[c] the product of
    exp(Lc) over the later chunks, and E the product over all."""
    B, n, H, hd = kb.shape
    terms, ecs = [], []
    for c0 in range(0, n, chunk):
        L = torch.cumsum(lb[:, c0:c0 + chunk], dim=1)
        Lc = L[:, -1]
        terms.append((kb[:, c0:c0 + chunk] * torch.exp(Lc[:, None] - L),
                      vb[:, c0:c0 + chunk]))
        ecs.append(torch.exp(Lc))
    after = [kb.new_ones(B, H, hd)]
    for ec in reversed(ecs[1:]):
        after.insert(0, after[0] * ec)
    ds = kb.new_zeros(B, H, hd, hd)
    for (kd, v), ea in zip(terms, after):
        ds = ds + torch.einsum("bshd,bshe->bhde", kd * ea[:, None], v)
    decay = after[0] * ecs[0] if ecs else after[0]
    return ds, decay


def wkv6_segmented(r, k, v, log_decay, u, s0, n_seg: int, seg_len: int,
                   chunk: int = SEG_CHUNK, sub: int = SEG_SUB):
    """WKV6 as the CUDA kernel decomposes it, in fp32.

    Each round covers ``n_seg`` segments of ``seg_len`` tokens (the last
    ones short or empty). Every segment forms its local state from zero
    and its decay (:func:`_segment_delta`). Segment j's incoming state is
    the round's incoming state carried through segments 0..j-1 in order:
    s <- s * E_i + ds_i, every factor <= 1. With it, the segment runs its
    chunks (:func:`_chunk_step`) and writes its outputs. The next round
    starts from the chain through all the round's segments; the final
    state is the last segment's own, after its chunks."""
    B, S, H, hd = r.shape
    f32 = torch.float32
    r, k, v, ld = (x.to(f32) for x in (r, k, v, log_decay))
    u = u.to(f32)
    carry = s0.to(f32)
    rounds = -(-S // (n_seg * seg_len))
    o = r.new_zeros(B, S, H, hd)
    s_fin = carry
    for rnd in range(rounds):
        s = carry
        for j in range(n_seg):
            a = (rnd * n_seg + j) * seg_len
            b = max(a, min(a + seg_len, S))
            st = s
            for c0 in range(a, b, chunk):
                c1 = min(c0 + chunk, b)
                o[:, c0:c1], st = _chunk_step(r[:, c0:c1], k[:, c0:c1],
                                              v[:, c0:c1], ld[:, c0:c1], u,
                                              st, sub)
            s_fin = st
            ds, decay = _segment_delta(k[:, a:b], v[:, a:b], ld[:, a:b],
                                       chunk)
            s = s * decay[..., None] + ds
        carry = s
    return o, s_fin
