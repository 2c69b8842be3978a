"""Plain PyTorch version of the fused LSTM cell and of its gradient, in the
kernel's layout."""
from __future__ import annotations

from typing import Optional

import torch


def lstm_cell_fwd_plain(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor):
    """xh: (B, D+H); w: (D+H, H, 4); b: (H, 4); c: (B, H).
    Returns (h_new, c_new, z): the new state, each (B, H), and the gates'
    preactivations z = xh W + b (B, H, 4), gates i|f|g|o on the last axis,
    which the backward takes. Computes in at least float32, as the kernel
    accumulates (float64 stays float64, for gradcheck)."""
    acc = torch.promote_types(xh.dtype, torch.float32)
    z = torch.einsum("bd,dhg->bhg", xh.to(acc), w.to(acc)) + b.to(acc)[None]
    i, f, g, o = z.unbind(-1)
    c_new = torch.sigmoid(f + 1.0) * c.to(acc) \
        + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(xh.dtype), c_new.to(xh.dtype), z


def lstm_cell_ref(xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor):
    """xh: (B, D+H); w: (D+H, H, 4); b: (H, 4); c: (B, H).
    Returns (h_new, c_new), each (B, H)."""
    return lstm_cell_fwd_plain(xh, w, b, c)[:2]


# calls of the plain backwards (``lstm_cell_bwd_plain``,
# ``lstm_seq_bwd_plain``) on CUDA tensors: a run on the card shows by a 0
# here that no backward went through a plain version
plain_cuda_calls = 0


def _gate_bwd(z, c, dh, dc):
    """(dz (B, H, 4), dc_prev (B, H)) of one step from its preactivations z,
    the state c it started from and the cotangents dh, dc of its h and c;
    c_new and tanh(c_new) are recomputed, the forget gate's +1 applied as
    in the forward."""
    si, sf, tg, so = (torch.sigmoid(z[..., 0]), torch.sigmoid(z[..., 1] + 1.0),
                      torch.tanh(z[..., 2]), torch.sigmoid(z[..., 3]))
    tc = torch.tanh(sf * c + si * tg)
    dc_new = dc + dh * so * (1.0 - tc * tc)
    dz = torch.stack([dc_new * tg * si * (1.0 - si),
                      dc_new * c * sf * (1.0 - sf),
                      dc_new * si * (1.0 - tg * tg),
                      dh * tc * so * (1.0 - so)], dim=-1)
    return dz, dc_new * sf


def lstm_cell_bwd_plain(z: torch.Tensor, c: torch.Tensor, w: torch.Tensor,
                        dh: torch.Tensor, dc: torch.Tensor,
                        dh_up: Optional[torch.Tensor] = None):
    """The gradient of one timestep from its saved preactivations.

    z: (B, H, 4) the step's gate preactivations (``lstm_cell_fwd_plain``);
    c: (B, H) the state it started from; w: (D+H, H, 4); dh, dc: (B, H) the
    cotangents of h_new and c_new, and ``dh_up`` (B, H) a second share of
    h_new's, added to ``dh``. Returns (dz (B, H, 4), dxh = dz W^T (B, D+H),
    dc_prev (B, H)). Computes in at least float32 (float64 stays
    float64)."""
    global plain_cuda_calls
    if z.is_cuda:
        plain_cuda_calls += 1
    acc = torch.promote_types(z.dtype, torch.float32)
    dh = dh.to(acc) if dh_up is None else dh.to(acc) + dh_up.to(acc)
    dz, dc_prev = _gate_bwd(z.to(acc), c.to(acc), dh, dc.to(acc))
    k, h, _ = w.shape
    dxh = dz.reshape(-1, 4 * h) @ w.to(acc).reshape(k, 4 * h).T
    return dz, dxh, dc_prev


def lstm_seq_bwd_plain(zs: torch.Tensor, cs: torch.Tensor, w: torch.Tensor,
                       g: torch.Tensor, dc: Optional[torch.Tensor] = None):
    """A layer's backward walk, the plain version of the walk kernel
    (``csrc/lstm_seq_bwd.cu``): zs (S, B, H, 4) the saved preactivations in
    step order, cs (S+1, B, H) the c's (cs[t] the state step t started
    from), w (D+H, H, 4) of which only the recurrent rows w[D:] are read,
    g (S, B, H) the layer's own cotangents of h in step order, dc (B, H) or
    None the cotangent of the last step's c. For t = S-1 ... 0 it takes
    dh = carry + g[t], forms dz_t and the new dc by a step's gate math and
    carries dz_t W_h^T back. Returns (dzs (S, B, H, 4), dh0, dc0 (B, H)):
    h0's and c0's cotangents are the carry and dc after step 0. Computes in
    at least float32 (float64 stays float64)."""
    global plain_cuda_calls
    if zs.is_cuda:
        plain_cuda_calls += 1
    acc = torch.promote_types(zs.dtype, torch.float32)
    s, b, h, _ = zs.shape
    wh = w[w.shape[0] - h:].to(acc).reshape(h, 4 * h)
    dzs = zs.new_empty(zs.shape, dtype=acc)
    carry = zs.new_zeros((b, h), dtype=acc)
    dc = carry if dc is None else dc.to(acc)
    for t in range(s - 1, -1, -1):
        dzs[t], dc = _gate_bwd(zs[t].to(acc), cs[t].to(acc),
                               carry + g[t].to(acc), dc)
        carry = dzs[t].reshape(b, 4 * h) @ wh.T
    return dzs, carry, dc
