"""Selective scan over a whole sequence and its gradient: the full-sequence
half of the SSM mixer (prefill and training).

``selective_scan_fwd`` and ``selective_scan_bwd`` launch the CUDA kernels in
``csrc/ssm_scan.cu`` for CUDA tensors and run
:func:`selective_scan_fwd_reference` and :func:`selective_scan_bwd_reference`,
their plain PyTorch versions, for CPU tensors. They replace the forward and
the custom-VJP backward of
``apertis_llm_tpu/ops/pallas/ssm_scan.py::gated_scan_2d`` (whose reverse scan
is ``selective_scan_pallas``'s core, ``_scan_2d``) together with the layout
work ``ops/ssm.py::ssm_mix`` did around it, and ``exp(delta * A)``, whose
gradient XLA derived there: the backward returns the gradients of
``delta`` and ``A`` themselves.

``selective_scan_carry_fwd`` and ``selective_scan_carry_bwd`` launch the
kernels in ``csrc/scan_carry.cu`` (plain versions
:func:`selective_scan_carry_fwd_reference` and
:func:`selective_scan_carry_bwd_reference`): the plain scan over given decays
and inputs from a carried state, in the (B, H, L, N) layout, and its
gradient, which replace ``selective_scan_pallas`` (the forward and custom VJP
of ``ssm_scan.py:129-194``) on the sequence-parallel path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apertis_llm_torch.ops.kernels import _build


def _decay(delta: torch.Tensor, a_cont: torch.Tensor,
           seq_mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(a (B, L, H, N) f32, m (B, L, 1, 1) f32 or None)``: ``a =
    exp(delta * A)``, 1 at masked steps."""
    a_bar = torch.exp(delta.float()[..., None] * a_cont.float())
    if seq_mask is None:
        return a_bar, None
    m = (seq_mask != 0).float()[:, :, None, None]
    return a_bar * m + (1.0 - m), m


def selective_scan_fwd_reference(
    delta: torch.Tensor,      # (B, L, H) float32 softplus'd timescales
    a_cont: torch.Tensor,     # (H, N) float32 continuous-time A (negative)
    b_term: torch.Tensor,     # (B, L, H, N) recurrence inputs
    c_mod: torch.Tensor,      # (B, L, H, N) output gates
    seq_mask: Optional[torch.Tensor] = None,  # (B, L), nonzero = real token
    out_dtype: Optional[torch.dtype] = None,
    want_h: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``y = C * scan(exp(delta * A), B)`` step by step with an f32 carry;
    a masked step is the identity (a = 1, b = 0). Returns ``(y (B, L, H*N)
    in out_dtype, h_last (B, H, N) float32)``, and every state ``h (B, L, H,
    N)`` float32 after them with ``want_h``."""
    b, l, h, n = b_term.shape
    a_bar, m = _decay(delta, a_cont, seq_mask)
    bb = b_term.float() if m is None else b_term.float() * m
    carry = torch.zeros((b, h, n), dtype=torch.float32, device=b_term.device)
    hs = torch.empty((b, l, h, n), dtype=torch.float32, device=b_term.device)
    for t in range(l):
        carry = a_bar[:, t] * carry + bb[:, t]
        hs[:, t] = carry
    y = (c_mod.float() * hs).reshape(b, l, h * n).to(out_dtype or b_term.dtype)
    return (y, carry, hs) if want_h else (y, carry)


def selective_scan_fwd(
    delta: torch.Tensor,
    a_cont: torch.Tensor,
    b_term: torch.Tensor,
    c_mod: torch.Tensor,
    seq_mask: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
    want_h: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The selective scan: kernel on CUDA tensors, plain version on CPU ones.

    The kernel takes ``delta`` and ``a_cont`` in float32, ``b_term`` and
    ``c_mod`` contiguous in one dtype (bfloat16 or float32), ``seq_mask`` as a
    contiguous int32 (B, L) or None, and ``out_dtype`` bfloat16 or float32.
    With ``want_h`` it also writes every state (B, L, H, N) in float32, which
    the backward reads.
    """
    out_dtype = out_dtype or b_term.dtype
    if b_term.device.type == "cpu":
        return selective_scan_fwd_reference(delta, a_cont, b_term, c_mod,
                                            seq_mask, out_dtype, want_h)
    bsz, l, h, n = b_term.shape
    dev = b_term.device
    _build.check_tensor(delta, (bsz, l, h), (torch.float32,), "delta", dev)
    _build.check_tensor(a_cont, (h, n), (torch.float32,), "a_cont", dev)
    _build.check_tensor(b_term, (bsz, l, h, n), (torch.bfloat16, torch.float32), "b_term", dev)
    _build.check_tensor(c_mod, (bsz, l, h, n), (b_term.dtype,), "c_mod", dev)
    if seq_mask is not None:
        _build.check_tensor(seq_mask, (bsz, l), (torch.int32,), "seq_mask", dev)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"selective_scan_fwd: out_dtype {out_dtype} not supported")
    if bsz == 0 or l == 0 or h * n == 0:
        raise ValueError(f"selective_scan_fwd: empty shape {tuple(b_term.shape)}")
    y = torch.empty((bsz, l, h * n), dtype=out_dtype, device=dev)
    h_last = torch.empty((bsz, h, n), dtype=torch.float32, device=dev)
    hs = torch.empty((bsz, l, h, n), dtype=torch.float32, device=dev) if want_h else None
    err = _build.load_library().apertis_selective_scan_fwd(
        delta.data_ptr(), a_cont.data_ptr(), b_term.data_ptr(), c_mod.data_ptr(),
        seq_mask.data_ptr() if seq_mask is not None else None,
        y.data_ptr(), h_last.data_ptr(), hs.data_ptr() if want_h else None, bsz, l, h, n,
        int(b_term.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "selective_scan_fwd")
    selective_scan_fwd.launches += 1
    return (y, h_last, hs) if want_h else (y, h_last)


selective_scan_fwd.launches = 0


def selective_scan_bwd_reference(
    delta: torch.Tensor,      # (B, L, H) float32
    a_cont: torch.Tensor,     # (H, N) float32
    c_mod: torch.Tensor,      # (B, L, H, N), b_term's dtype
    seq_mask: Optional[torch.Tensor],   # (B, L) or None
    hs: torch.Tensor,         # (B, L, H, N) float32, the forward's states
    gy: torch.Tensor,         # (B, L, H*N) dL/dy
    g_last: Optional[torch.Tensor] = None,   # (B, H, N) dL/dh_last
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan adjoint (ssm_scan.py:302-321) in f32, step by step from the
    end: ``dh = gy * C`` (+ ``g_last`` at the last step), ``lam[t] = dh[t] +
    a[t+1] lam[t+1]``, ``dC = gy * h``, ``dB = lam``, ``da = lam * h[t-1]``,
    then through ``a = exp(delta * A)``: ``d_delta = sum_n da * a * A`` and
    ``dA = sum_{b,t} da * a * delta``; a masked step gives no ``d_delta``,
    ``dA`` or ``dB``. Returns ``(d_delta (B, L, H) f32, dA (H, N) f32, dB,
    dC (B, L, H, N) in c_mod's dtype)``."""
    b, l, h, n = hs.shape
    a_bar, m = _decay(delta, a_cont, seq_mask)
    g = gy.float().reshape(b, l, h, n)
    dh = g * c_mod.float()
    if g_last is not None:
        dh[:, -1] += g_last.float()
    lam = torch.empty_like(dh)
    carry = torch.zeros_like(dh[:, 0])
    for t in range(l - 1, -1, -1):
        a_next = a_bar[:, t + 1] if t + 1 < l else torch.ones_like(carry)
        carry = dh[:, t] + a_next * carry
        lam[:, t] = carry
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], dim=1)
    chain = lam * h_prev * a_bar          # dL/d(delta * A)
    if m is not None:
        chain = chain * m
        lam = lam * m
    d_delta = (chain * a_cont.float()).sum(dim=-1)
    d_a = (chain * delta.float()[..., None]).sum(dim=(0, 1))
    return d_delta, d_a, lam.to(c_mod.dtype), (g * hs).to(c_mod.dtype)


def _scan_bwd_launch(entry: str, name: str, delta, a_cont, c_mod, seq_mask, hs, gy, g_last):
    """Check the backward's operands and launch the C entry point ``entry``."""
    bsz, l, h, n = hs.shape
    dev = c_mod.device
    _build.check_tensor(delta, (bsz, l, h), (torch.float32,), "delta", dev)
    _build.check_tensor(a_cont, (h, n), (torch.float32,), "a_cont", dev)
    _build.check_tensor(c_mod, (bsz, l, h, n), (torch.bfloat16, torch.float32), "c_mod", dev)
    _build.check_tensor(hs, (bsz, l, h, n), (torch.float32,), "hs", dev)
    _build.check_tensor(gy, (bsz, l, h * n), (torch.bfloat16, torch.float32), "gy", dev)
    if g_last is not None:
        _build.check_tensor(g_last, (bsz, h, n), (torch.float32,), "g_last", dev)
    if seq_mask is not None:
        _build.check_tensor(seq_mask, (bsz, l), (torch.int32,), "seq_mask", dev)
    if bsz * l * h == 0:
        raise ValueError(f"{name}: empty shape {tuple(hs.shape)}")
    d_delta = torch.empty((bsz, l, h), dtype=torch.float32, device=dev)
    d_a = torch.empty((h, n), dtype=torch.float32, device=dev)
    db = torch.empty_like(c_mod)
    dc = torch.empty_like(c_mod)
    da_part = torch.empty((bsz, h * n), dtype=torch.float32, device=dev)
    err = getattr(_build.load_library(), entry)(
        delta.data_ptr(), a_cont.data_ptr(), c_mod.data_ptr(),
        seq_mask.data_ptr() if seq_mask is not None else None, hs.data_ptr(), gy.data_ptr(),
        g_last.data_ptr() if g_last is not None else None, d_delta.data_ptr(), d_a.data_ptr(),
        db.data_ptr(), dc.data_ptr(), da_part.data_ptr(), bsz, l, h, n,
        int(c_mod.dtype == torch.bfloat16), int(gy.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, name)
    return d_delta, d_a, db, dc


def _warp_state(n: int) -> bool:
    """True when a head's ``n`` channels fit neighbouring lanes of one warp
    (``n`` a power of two up to 32): the backward kernel
    :func:`selective_scan_bwd` launches sums them by warp shuffles; any other
    ``n`` takes :func:`selective_scan_bwd_smem`."""
    return 0 < n <= 32 and n & (n - 1) == 0


def selective_scan_bwd(
    delta: torch.Tensor,
    a_cont: torch.Tensor,
    c_mod: torch.Tensor,
    seq_mask: Optional[torch.Tensor],
    hs: torch.Tensor,
    gy: torch.Tensor,
    g_last: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan's gradient: kernel on CUDA tensors, plain version on CPU ones.

    The kernel takes the forward's ``delta``, ``a_cont``, ``c_mod`` and
    ``seq_mask`` as :func:`selective_scan_fwd` does, its states ``hs``
    (B, L, H, N) float32, ``gy`` (B, L, H*N) contiguous in bfloat16 or
    float32 and ``g_last`` (B, H, N) float32 or None. With N a power of two
    up to 32 (a head's channels share one warp) it launches the warp-shuffle
    kernel; any other N goes to :func:`selective_scan_bwd_smem`."""
    if c_mod.device.type == "cpu":
        return selective_scan_bwd_reference(delta, a_cont, c_mod, seq_mask, hs, gy, g_last)
    if not _warp_state(hs.shape[-1]):
        return selective_scan_bwd_smem(delta, a_cont, c_mod, seq_mask, hs, gy, g_last)
    out = _scan_bwd_launch("apertis_selective_scan_bwd", "selective_scan_bwd", delta, a_cont,
                           c_mod, seq_mask, hs, gy, g_last)
    selective_scan_bwd.launches += 1
    return out


selective_scan_bwd.launches = 0


def selective_scan_bwd_smem(
    delta: torch.Tensor,
    a_cont: torch.Tensor,
    c_mod: torch.Tensor,
    seq_mask: Optional[torch.Tensor],
    hs: torch.Tensor,
    gy: torch.Tensor,
    g_last: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan's gradient at an N that is not a power of two up to 32 (at
    most 1024): kernel on CUDA tensors, whose blocks hold whole heads and sum
    each head's d_delta through shared memory in channel order; plain
    version on CPU ones. Takes what :func:`selective_scan_bwd` takes."""
    if c_mod.device.type == "cpu":
        return selective_scan_bwd_reference(delta, a_cont, c_mod, seq_mask, hs, gy, g_last)
    n = hs.shape[-1]
    if _warp_state(n) or n > 1024:
        raise ValueError(f"selective_scan_bwd_smem: N = {n} (takes N up to 1024 that is not "
                         "a power of two up to 32)")
    out = _scan_bwd_launch("apertis_selective_scan_bwd_smem", "selective_scan_bwd_smem", delta,
                           a_cont, c_mod, seq_mask, hs, gy, g_last)
    selective_scan_bwd_smem.launches += 1
    return out


selective_scan_bwd_smem.launches = 0


def selective_scan_carry_fwd_reference(
    a_bar: torch.Tensor,                     # (B, H, L, N) decays
    b_term: torch.Tensor,                    # (B, H, L, N) inputs
    h_init: Optional[torch.Tensor] = None,   # (B, H, N) carried state
    want_states: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """``h[t] = a[t] * h[t-1] + b[t]`` step by step in f32 from ``h[-1] =
    h_init`` (0 without one). Returns ``(h, h_last)`` in ``b_term``'s dtype,
    ``h_last = h[:, :, -1]``, and with ``want_states`` every f32 state after
    them."""
    a, b = a_bar.float(), b_term.float()
    bsz, heads, l, n = b.shape
    carry = (torch.zeros((bsz, heads, n), dtype=torch.float32, device=b.device)
             if h_init is None else h_init.float())
    states = torch.empty_like(b)
    for t in range(l):
        carry = a[:, :, t] * carry + b[:, :, t]
        states[:, :, t] = carry
    h = states.to(b_term.dtype)
    out = (h, h[:, :, -1].contiguous())
    return out + (states,) if want_states else out


def selective_scan_carry_fwd(
    a_bar: torch.Tensor,
    b_term: torch.Tensor,
    h_init: Optional[torch.Tensor] = None,
    want_states: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """The carried-state scan: kernel on CUDA tensors, plain version on CPU
    ones.

    The kernel takes ``a_bar`` (B, H, L, N) contiguous float32, ``b_term``
    of that shape contiguous in bfloat16 or float32, and ``h_init`` (B, H, N)
    contiguous float32 or None. It writes ``h`` and ``h_last`` in
    ``b_term``'s dtype and, with ``want_states``, returns the f32 states
    third (``h`` itself for f32 ``b_term``; for bf16 the kernel writes them
    too), which the backward reads.
    """
    if b_term.device.type == "cpu":
        return selective_scan_carry_fwd_reference(a_bar, b_term, h_init, want_states)
    bsz, heads, l, n = b_term.shape
    dev = b_term.device
    _build.check_tensor(a_bar, (bsz, heads, l, n), (torch.float32,), "a_bar", dev)
    _build.check_tensor(b_term, (bsz, heads, l, n), (torch.bfloat16, torch.float32), "b_term",
                        dev)
    if h_init is not None:
        _build.check_tensor(h_init, (bsz, heads, n), (torch.float32,), "h_init", dev)
    if bsz * heads * l * n == 0:
        raise ValueError(f"selective_scan_carry_fwd: empty shape {tuple(b_term.shape)}")
    bf16 = b_term.dtype == torch.bfloat16
    h = torch.empty_like(b_term)
    h_last = torch.empty((bsz, heads, n), dtype=b_term.dtype, device=dev)
    states = torch.empty_like(a_bar) if want_states and bf16 else None
    err = _build.load_library().apertis_scan_carry_fwd(
        a_bar.data_ptr(), b_term.data_ptr(), h_init.data_ptr() if h_init is not None else None,
        h.data_ptr(), h_last.data_ptr(), states.data_ptr() if states is not None else None,
        bsz * heads, l, n, int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "selective_scan_carry_fwd")
    selective_scan_carry_fwd.launches += 1
    if not want_states:
        return h, h_last
    return h, h_last, (states if bf16 else h)


selective_scan_carry_fwd.launches = 0


def selective_scan_carry_bwd_reference(
    a_bar: torch.Tensor,                     # (B, H, L, N) f32 decays
    g: torch.Tensor,                         # (B, H, L, N) dL/dh
    states: torch.Tensor,                    # (B, H, L, N) f32, the forward's states
    h_init: Optional[torch.Tensor] = None,   # (B, H, N)
    g_last: Optional[torch.Tensor] = None,   # (B, H, N) dL/dh_last
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The scan adjoint (ssm_scan.py:153-178) in f32, step by step from the
    end: ``lam[L-1] = g[L-1] + g_last``, ``lam[t] = g[t] + a[t+1] lam[t+1]``,
    ``da[t] = lam[t] h[t-1]`` (``h_init`` as ``h[-1]``), ``db[t] = lam[t]``.
    Returns ``(da, db, dh_init)`` in f32, ``dh_init = lam[0] a[0]`` (None
    without ``h_init``)."""
    a, g = a_bar.float(), g.float()
    bsz, heads, l, n = a.shape
    zero = torch.zeros((bsz, heads, n), dtype=torch.float32, device=a.device)
    lam = zero if g_last is None else g_last.float()
    h_first = zero if h_init is None else h_init.float()
    a_next = torch.ones_like(zero)
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in range(l - 1, -1, -1):
        lam = g[:, :, t] + a_next * lam
        da[:, :, t] = lam * (states[:, :, t - 1] if t > 0 else h_first)
        db[:, :, t] = lam
        a_next = a[:, :, t]
    return da, db, (None if h_init is None else lam * a_next)


def selective_scan_carry_bwd(
    a_bar: torch.Tensor,
    g: torch.Tensor,
    states: torch.Tensor,
    h_init: Optional[torch.Tensor] = None,
    g_last: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The carried-state scan's gradient: kernel on CUDA tensors, plain
    version on CPU ones. The kernel takes ``a_bar``, ``g`` and ``states``
    (B, H, L, N) and ``h_init`` and ``g_last`` (B, H, N) or None, each
    contiguous float32, and returns what the plain version returns."""
    if a_bar.device.type == "cpu":
        return selective_scan_carry_bwd_reference(a_bar, g, states, h_init, g_last)
    bsz, heads, l, n = a_bar.shape
    dev = a_bar.device
    for t, name in ((a_bar, "a_bar"), (g, "g"), (states, "states")):
        _build.check_tensor(t, (bsz, heads, l, n), (torch.float32,), name, dev)
    for t, name in ((h_init, "h_init"), (g_last, "g_last")):
        if t is not None:
            _build.check_tensor(t, (bsz, heads, n), (torch.float32,), name, dev)
    if bsz * heads * l * n == 0:
        raise ValueError(f"selective_scan_carry_bwd: empty shape {tuple(a_bar.shape)}")
    da, db = torch.empty_like(a_bar), torch.empty_like(a_bar)
    dh_init = torch.empty_like(h_init) if h_init is not None else None
    err = _build.load_library().apertis_scan_carry_bwd(
        a_bar.data_ptr(), g.data_ptr(), states.data_ptr(),
        h_init.data_ptr() if h_init is not None else None,
        g_last.data_ptr() if g_last is not None else None, da.data_ptr(), db.data_ptr(),
        dh_init.data_ptr() if dh_init is not None else None, bsz * heads, l, n,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "selective_scan_carry_bwd")
    selective_scan_carry_bwd.launches += 1
    return da, db, dh_init


selective_scan_carry_bwd.launches = 0
