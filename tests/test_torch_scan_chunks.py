"""The scan backwards' chunked time axis (``csrc/ssm_scan.cu``,
``csrc/scan_carry.cu``), on the CPU.

The kernels build and run only on the card, where ``chip_smoke.py`` holds
them against ``selective_scan_bwd_reference`` and
``selective_scan_carry_bwd_reference``. Here: numpy emulations of the
kernels' passes over chunks of ``BWD_CHUNK`` (#1) and ``CARRY_BWD_CHUNK``
(#2) steps (each chunk's local reverse scan and decay product, the carries
resolved from the later chunks, each chunk rerun from its carry; for #1
with dA's partials a (row, chunk) summed in order) against the sequential
plain versions.
"""

import numpy as np
import pytest
import torch

from apertis_llm_torch.ops.kernels.ssm_scan import (
    BWD_CHUNK, CARRY_BWD_CHUNK, selective_scan_bwd_reference, selective_scan_carry_bwd_reference,
    selective_scan_carry_fwd_reference, selective_scan_fwd_reference)


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
