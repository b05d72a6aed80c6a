"""The scans' chunked time axis (``csrc/ssm_scan.cu``, ``csrc/scan_carry.cu``),
on the CPU.

The kernels build and run only on the card, where ``chip_smoke.py`` holds
them against their plain versions. Here: numpy emulations of the kernels'
passes against the sequential plain versions. The backwards over chunks of
``BWD_CHUNK`` (#1) and ``CARRY_BWD_CHUNK`` (#2) steps: each chunk's local
reverse scan and decay product, the carries resolved from the later chunks,
each chunk rerun from its carry; for #1 with dA's partials a (row, chunk)
summed in order. The forwards over chunks of ``FWD_CHUNK`` (#1) and
``CARRY_FWD_CHUNK`` (#2): each chunk's local scan and decay product (pass
1), the carries resolved from the earlier chunks in one fixed order and each
chunk rerun from its carry (pass 2).
"""

import numpy as np
import pytest
import torch

from apertis_llm_torch.ops.kernels.ssm_scan import (
    BWD_CHUNK, CARRY_BWD_CHUNK, CARRY_FWD_CHUNK, FWD_CHUNK, selective_scan_bwd_reference,
    selective_scan_carry_bwd_reference, selective_scan_carry_fwd_reference,
    selective_scan_fwd_reference)

# chip_smoke.py's tolerances of the forwards, relative to the largest
# element: #1's f32 outputs (SCAN_F32_TOL) and #2's (CARRY_TOL).
SCAN_F32_TOL = 1e-4
CARRY_TOL = 1e-5


def _inputs(seed, b, l, h, n, masked):
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.normal(-4.0, 1.0, (b, l, h)))).astype(np.float32)
    a_cont = -rng.uniform(0.5, 0.99, (h, n)).astype(np.float32)
    bt = rng.normal(size=(b, l, h, n)).astype(np.float32)
    ct = rng.normal(size=(b, l, h, n)).astype(np.float32)
    gy = rng.normal(size=(b, l, h * n)).astype(np.float32)
    g_last = rng.normal(size=(b, h, n)).astype(np.float32)
    mask = None
    if masked:
        lens = rng.integers(1, l + 1, (b, 1))
        mask = (np.arange(l)[None, :] < lens).astype(np.int32)
    t = [None if v is None else torch.from_numpy(v) for v in (delta, a_cont, bt, ct, mask)]
    hs = selective_scan_fwd_reference(*t, torch.float32, want_h=True)[2].numpy()
    return delta, a_cont, ct, mask, hs, gy, g_last


def _chunked_bwd(delta, a_cont, ct, mask, hs, gy, g_last, chunk, resolve=True):
    """The kernels' arithmetic in numpy f32, thread by thread as arrays over
    (b, c): pass 1 (lam0, prod of chunks 1..K-1), the carry of each chunk
    resolved from the later ones (j = K-1 down to k+1), pass 3 from it, and
    dA's (row, chunk) partials summed in order. ``resolve=False`` drops the
    carries (each chunk from lam = 0): what the check must see."""
    f32 = np.float32
    b, l, h, n = hs.shape
    c = h * n
    chunks = -(-l // chunk)
    a_c = a_cont.reshape(c)
    dt = np.repeat(delta, n, axis=2)                          # (B, L, C)
    a = np.exp(dt * a_c).astype(f32)
    if mask is not None:
        a = np.where(mask[:, :, None] == 0, f32(1), a)
    dh = (gy * ct.reshape(b, l, c)).astype(f32)
    dh[:, -1] += g_last.reshape(b, c)
    h2 = hs.reshape(b, l, c)

    def decay(t):
        return a[:, t] if t < l else np.ones((b, c), f32)

    lam0 = np.zeros((chunks, b, c), f32)
    prod = np.ones((chunks, b, c), f32)
    for k in range(1, chunks):
        t0, t1 = k * chunk, min(k * chunk + chunk, l)
        a_next, lam, p = decay(t1), np.zeros((b, c), f32), decay(t1).copy()
        for t in range(t1 - 1, t0 - 1, -1):
            lam = (a_next * lam + dh[:, t]).astype(f32)
            a_next = decay(t)
            if t > t0:
                p = (p * a_next).astype(f32)
        lam0[k], prod[k] = lam, p
    lam_all = np.zeros((b, l, c), f32)
    da_part = np.zeros((chunks, b, c), f32)
    for k in range(chunks):
        t0, t1 = k * chunk, min(k * chunk + chunk, l)
        lam = np.zeros((b, c), f32)
        for j in range(chunks - 1, k, -1):
            if resolve:
                lam = (prod[j] * lam + lam0[j]).astype(f32)
        a_next = decay(t1)
        for t in range(t1 - 1, t0 - 1, -1):
            lam = (a_next * lam + dh[:, t]).astype(f32)
            lam_all[:, t] = lam
            h_prev = h2[:, t - 1] if t > 0 else np.zeros((b, c), f32)
            chain = (lam * h_prev * a[:, t]).astype(f32)
            if mask is not None:
                chain = np.where(mask[:, t, None] == 0, f32(0), chain)
            da_part[k] += (chain * dt[:, t]).astype(f32)
            a_next = a[:, t]
    m = np.ones((b, l, 1), f32) if mask is None else mask[:, :, None].astype(f32)
    h_prev = np.concatenate([np.zeros((b, 1, c), f32), h2[:, :-1]], axis=1)
    chain = lam_all * h_prev * a * m
    d_delta = (chain * a_c[None, None, :]).reshape(b, l, h, n).sum(axis=-1)
    d_a = np.zeros(c, f32)
    for bb in range(b):              # sum_rows_kernel's order: row-major (b, chunk)
        for k in range(chunks):
            d_a += da_part[k, bb]
    db = (lam_all * m).reshape(b, l, h, n)
    dc = (gy.reshape(b, l, c) * h2).reshape(b, l, h, n)
    return d_delta, d_a.reshape(h, n), db, dc


@pytest.mark.parametrize("l,chunk,masked", [(150, BWD_CHUNK, True), (150, BWD_CHUNK, False),
                                            (77, BWD_CHUNK, True), (20, BWD_CHUNK, True),
                                            (77, 64, True), (64, 64, True)])
def test_chunked_passes_match_the_sequential_backward(l, chunk, masked):
    """The three passes against ``selective_scan_bwd_reference`` (f32,
    sequential), L not a multiple of the chunk, with g_last, masked and not:
    every output within 1e-5 of its largest value (the chunked carry
    reassociates lam's sums, about an f32 ulp a chunk boundary; the kernel is
    held to 1e-4 on the card). Dropping the carries must fail the check."""
    args = _inputs(l + chunk, 3, l, 4, 16, masked)
    delta, a_cont, ct, mask, hs, gy, g_last = args
    tt = [None if x is None else torch.from_numpy(x) for x in args]
    ref = selective_scan_bwd_reference(*tt)
    got = _chunked_bwd(*args, chunk)
    for name, g, r in zip(("d_delta", "dA", "dB", "dC"), got, ref):
        r = r.float().numpy()
        assert g.shape == r.shape, name
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), (name, np.abs(g - r).max())
    if -(-l // chunk) > 1:
        wrong = _chunked_bwd(*args, chunk, resolve=False)
        r = ref[2].float().numpy()
        assert np.abs(wrong[2] - r).max() > 1e-3 * np.abs(r).max()


# ---- the carried-state scan's backward (#2, csrc/scan_carry.cu) ---------------

def _carry_inputs(seed, b, h, l, n, with_init, with_last):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.4, 0.999, (b, h, l, n)).astype(np.float32)
    bt = rng.normal(size=(b, h, l, n)).astype(np.float32)
    h0 = rng.normal(size=(b, h, n)).astype(np.float32) if with_init else None
    g = rng.normal(size=(b, h, l, n)).astype(np.float32)
    g_last = rng.normal(size=(b, h, n)).astype(np.float32) if with_last else None
    t = [None if v is None else torch.from_numpy(v) for v in (a, bt, h0)]
    states = selective_scan_carry_fwd_reference(*t, want_states=True)[2].numpy()
    return a, g, states, h0, g_last


def _chunked_carry_bwd(a, g, states, h_init, g_last, chunk, resolve=True):
    """scan_carry.cu's two passes in numpy f32, thread by thread as arrays
    over (r, n): pass 1's (lam0, prod) of chunks 1..K-1 (a[L] = 1), then
    each chunk's carry resolved from lam[L] = g_last and the later chunks (j
    = K-1 down to k+1), the chunk rerun from it writing da and db, and chunk
    0's dh_init; every product and sum rounded once, as the kernels'
    ``__fmul_rn`` / ``__fadd_rn``. ``resolve=False`` drops the carries
    (each chunk from lam[L] alone): what the check must see."""
    f32 = np.float32
    b, h, l, n = a.shape
    chunks = -(-l // chunk)
    zero = np.zeros((b, h, n), f32)

    def decay(t):
        return a[:, :, t] if t < l else np.ones((b, h, n), f32)

    lam0 = np.zeros((chunks, b, h, n), f32)
    prod = np.ones((chunks, b, h, n), f32)
    for k in range(1, chunks):
        t0, t1 = k * chunk, min(k * chunk + chunk, l)
        a_next, lam, p = decay(t1), zero.copy(), decay(t1).copy()
        for t in range(t1 - 1, t0 - 1, -1):
            lam = g[:, :, t] + a_next * lam
            a_next = a[:, :, t]
            if t > t0:
                p = p * a_next
        lam0[k], prod[k] = lam, p
    da, db = np.empty_like(a), np.empty_like(a)
    h_first = zero if h_init is None else h_init
    dh_init = None
    for k in range(chunks):
        t0, t1 = k * chunk, min(k * chunk + chunk, l)
        lam = zero.copy() if g_last is None else g_last.copy()
        for j in range(chunks - 1, k, -1):
            if resolve:
                lam = lam0[j] + prod[j] * lam
        a_next = decay(t1)
        for t in range(t1 - 1, t0 - 1, -1):
            lam = g[:, :, t] + a_next * lam
            da[:, :, t] = lam * (states[:, :, t - 1] if t > 0 else h_first)
            db[:, :, t] = lam
            a_next = a[:, :, t]
        if k == 0 and h_init is not None:
            dh_init = lam * a_next
    return da, db, dh_init


@pytest.mark.parametrize("l,with_init,with_last", [
    (300, True, True), (300, False, True), (300, True, False), (300, False, False),
    (77, True, True), (CARRY_BWD_CHUNK, True, True), (20, False, True)])
def test_chunked_carry_passes_match_the_sequential_backward(l, with_init, with_last):
    """The two passes against ``selective_scan_carry_bwd_reference`` (f32,
    sequential), with and without h_init and g_last (the wrapper's two call
    forms), L = 300 and 77 not multiples of the chunk: every output within
    1e-5 of its largest value (the chunked carry reassociates lam's sums;
    the kernel is held to 1e-4 on the card), and bit for bit where L fits
    one chunk. Dropping the carries must fail the check."""
    args = _carry_inputs(l * 4 + 2 * with_init + with_last, 2, 3, l, 16, with_init, with_last)
    tt = [None if x is None else torch.from_numpy(x) for x in args]
    ref = selective_scan_carry_bwd_reference(*tt)
    got = _chunked_carry_bwd(*args, CARRY_BWD_CHUNK)
    for name, gv, r in zip(("da", "db", "dh_init"), got, ref):
        if r is None:
            assert gv is None, name
            continue
        r = r.numpy()
        assert gv.shape == r.shape, name
        if l <= CARRY_BWD_CHUNK:
            assert np.array_equal(gv, r), name
        assert np.abs(gv - r).max() <= 1e-5 * np.abs(r).max(), (name, np.abs(gv - r).max())
    if l > CARRY_BWD_CHUNK:
        wrong = _chunked_carry_bwd(*args, CARRY_BWD_CHUNK, resolve=False)
        r = ref[1].numpy()
        assert np.abs(wrong[1] - r).max() > 1e-3 * np.abs(r).max()


# ---- the forwards (#1 and #2): pass 1, then pass 2 ---------------------------

def _fwd_inputs(seed, b, l, h, n, masked):
    rng = np.random.default_rng(seed)
    delta = np.log1p(np.exp(rng.normal(-4.0, 1.0, (b, l, h)))).astype(np.float32)
    a_cont = -rng.uniform(0.5, 0.99, (h, n)).astype(np.float32)
    bt = rng.normal(size=(b, l, h, n)).astype(np.float32)
    ct = rng.normal(size=(b, l, h, n)).astype(np.float32)
    mask = None
    if masked:
        lens = rng.integers(1, l + 1, (b, 1))
        mask = (np.arange(l)[None, :] < lens).astype(np.int32)
    return delta, a_cont, bt, ct, mask


def _chunked_fwd(delta, a_cont, bt, ct, mask, chunk, resolve=True):
    """ssm_scan.cu's two forward passes in numpy f32, thread by thread as
    arrays over (b, c), with the plain version's arithmetic (its decays,
    one rounding a product and a sum): pass 1's (local, prod) of chunks
    0..K-2, then each chunk's carry resolved from h = 0 and the earlier
    chunks (j = 0 up to k-1), the chunk rerun from it writing y and h, and
    the last chunk's h_last. A masked step is a = 1, b = 0.
    ``resolve=False`` drops the carries (each chunk from h = 0): what the
    check must see. Returns ``(y (B, L, C), h_last (B, H, N), h (B, L, H,
    N))``."""
    f32 = np.float32
    b, l, h, n = bt.shape
    c = h * n
    chunks = -(-l // chunk)
    a = torch.exp(torch.from_numpy(delta)[..., None] * torch.from_numpy(a_cont)).numpy()
    a, u, gate = a.reshape(b, l, c), bt.reshape(b, l, c), ct.reshape(b, l, c)
    if mask is not None:
        a = np.where(mask[:, :, None] == 0, f32(1), a)
        u = np.where(mask[:, :, None] == 0, f32(0), u)
    local = np.zeros((chunks, b, c), f32)
    prod = np.ones((chunks, b, c), f32)
    for k in range(chunks - 1):
        hh, p = np.zeros((b, c), f32), np.ones((b, c), f32)
        for t in range(k * chunk, min(k * chunk + chunk, l)):
            hh = a[:, t] * hh + u[:, t]
            p = p * a[:, t]
        local[k], prod[k] = hh, p
    hs = np.empty((b, l, c), f32)
    for k in range(chunks):
        hh = np.zeros((b, c), f32)
        for j in range(k if resolve else 0):
            hh = prod[j] * hh + local[j]
        for t in range(k * chunk, min(k * chunk + chunk, l)):
            hh = a[:, t] * hh + u[:, t]
            hs[:, t] = hh
    return gate * hs, hh.reshape(b, h, n), hs.reshape(b, l, h, n)


def _within(got, ref, tol):
    return np.abs(got - ref).max() <= tol * np.abs(ref).max()


@pytest.mark.parametrize("l,chunk,masked", [
    (150, FWD_CHUNK, True), (150, FWD_CHUNK, False), (77, FWD_CHUNK, True),
    (77, 16, False), (20, FWD_CHUNK, True), (20, 8, False), (FWD_CHUNK, FWD_CHUNK, False)])
def test_chunked_forward_passes_match_the_sequential_forward(l, chunk, masked):
    """#1's two forward passes against ``selective_scan_fwd_reference`` (f32,
    sequential), masked and not, at chunks that do not divide L: y, h_last
    and every h within the smoke's SCAN_F32_TOL of their largest value (the
    chunked carry reassociates h's sums, about an f32 ulp a chunk boundary),
    and bit for bit where L fits one chunk. Dropping the carries must fail
    the check."""
    args = _fwd_inputs(3 * l + chunk + masked, 3, l, 4, 16, masked)
    tt = [None if x is None else torch.from_numpy(x) for x in args]
    ref = [r.numpy() for r in selective_scan_fwd_reference(*tt, torch.float32, want_h=True)]
    got = _chunked_fwd(*args, chunk)
    for name, g, r in zip(("y", "h_last", "hs"), got, ref):
        assert g.shape == r.shape, name
        if l <= chunk:
            assert np.array_equal(g, r), name
        assert _within(g, r, SCAN_F32_TOL), (name, np.abs(g - r).max())
    if l > chunk:
        wrong = _chunked_fwd(*args, chunk, resolve=False)
        assert not _within(wrong[2], ref[2], SCAN_F32_TOL)
        assert not _within(wrong[0], ref[0], SCAN_F32_TOL)


def _chunked_carry_fwd(a, bt, h_init, chunk, resolve=True):
    """scan_carry.cu's two forward passes in numpy f32, thread by thread as
    arrays over (r, n), every product and sum rounded once as the kernels'
    ``__fmul_rn`` / ``__fadd_rn``: pass 1's (local, prod) of chunks 0..K-2,
    then each chunk's carry resolved from h_init (0 without one) and the
    earlier chunks (j = 0 up to k-1), the chunk rerun from it, and the last
    chunk's h_last. ``resolve=False`` drops the carries (each chunk from
    h_init alone): what the check must see. Returns ``(h, h_last, states)``
    in f32."""
    f32 = np.float32
    b, h, l, n = a.shape
    chunks = -(-l // chunk)
    start = np.zeros((b, h, n), f32) if h_init is None else h_init
    local = np.zeros((chunks, b, h, n), f32)
    prod = np.ones((chunks, b, h, n), f32)
    for k in range(chunks - 1):
        hh, p = np.zeros((b, h, n), f32), np.ones((b, h, n), f32)
        for t in range(k * chunk, min(k * chunk + chunk, l)):
            hh = a[:, :, t] * hh + bt[:, :, t]
            p = p * a[:, :, t]
        local[k], prod[k] = hh, p
    states = np.empty_like(a)
    for k in range(chunks):
        hh = start.copy()
        for j in range(k if resolve else 0):
            hh = prod[j] * hh + local[j]
        for t in range(k * chunk, min(k * chunk + chunk, l)):
            hh = a[:, :, t] * hh + bt[:, :, t]
            states[:, :, t] = hh
    return states, hh, states


@pytest.mark.parametrize("l,chunk,with_init", [
    (300, CARRY_FWD_CHUNK, True), (150, CARRY_FWD_CHUNK, True), (150, CARRY_FWD_CHUNK, False),
    (77, CARRY_FWD_CHUNK, True), (77, 16, False), (20, CARRY_FWD_CHUNK, True),
    (CARRY_FWD_CHUNK, CARRY_FWD_CHUNK, True), (10, CARRY_FWD_CHUNK, False)])
def test_chunked_carry_forward_passes_match_the_sequential_forward(l, chunk, with_init):
    """#2's two forward passes against ``selective_scan_carry_fwd_reference``
    (f32, sequential), with and without h_init, at chunks that do not divide
    L: h, h_last and the states within the smoke's CARRY_TOL of their largest
    value (the chunked carry reassociates h's sums), and bit for bit where L
    fits one chunk. Dropping the carries must fail the check."""
    rng = np.random.default_rng(5 * l + chunk + with_init)
    a = rng.uniform(0.4, 0.999, (2, 3, l, 16)).astype(np.float32)
    bt = rng.normal(size=(2, 3, l, 16)).astype(np.float32)
    h0 = rng.normal(size=(2, 3, 16)).astype(np.float32) if with_init else None
    tt = [None if x is None else torch.from_numpy(x) for x in (a, bt, h0)]
    ref = [r.numpy() for r in selective_scan_carry_fwd_reference(*tt, want_states=True)]
    got = _chunked_carry_fwd(a, bt, h0, chunk)
    for name, g, r in zip(("h", "h_last", "states"), got, ref):
        assert g.shape == r.shape, name
        if l <= chunk:
            assert np.array_equal(g, r), name
        assert _within(g, r, CARRY_TOL), (name, np.abs(g - r).max())
    if l > chunk:
        wrong = _chunked_carry_fwd(a, bt, h0, chunk, resolve=False)
        assert not _within(wrong[0], ref[0], CARRY_TOL)
