"""Plain PyTorch versions of the RWKV6 WKV recurrence.

- :func:`wkv6_ref`: the token-by-token oracle (port of
  ``repro/kernels/wkv6/ref.py``).
- :func:`wkv_chunked`: the chunked form of the reference model (port of
  ``repro/models/rwkv6.py::wkv_chunked``), in its float order. CPU tensors
  take it, so that the port's model on the CPU sums as the reference's
  does; the kernel checks compare with it at full size.

Both take r, k, v and log_decay (B, S, H, hd), u (H, hd) and the state s0
(B, H, hd, hd), which maps a k channel to a v channel, and return
(o (B, S, H, hd), final state), in fp32.
"""
from __future__ import annotations

import torch

WKV_CHUNK = 32  # the reference model's chunk


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
    """Chunked-parallel WKV6; the pairwise decays inside a chunk are
    masked to s < t after the exponential, as in the reference."""
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
    s = s0.to(f32)
    outs = []
    for rb, kb, vb, lb in zip(rc, kc, vc, ldc):  # (B, c, H, hd)
        L = torch.cumsum(lb, dim=1)  # inclusive
        Lx = L - lb  # exclusive
        decay = torch.exp(Lx[:, :, None] - L[:, None, :])  # (B, t, s, H, hd)
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
        outs.append(o)
    o = torch.stack(outs, dim=1).reshape(B, S, H, hd)
    return o, s
