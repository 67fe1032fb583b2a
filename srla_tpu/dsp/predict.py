"""Quantized integer FIR prediction / synthesis (host reference path).

Encode-side prediction is embarrassingly parallel (a batched int32 sliding
window dot, wrapping mod 2^32 like the reference's int arithmetic); decode-side
synthesis is a true order-p recurrence, run here as a sample-sequential loop
vectorized over blocks. The device paths live in srla_tpu/kernels/.
(Parity: srla_encoder/src/srla_lpc_predict.c:235-294,
 srla_decoder/src/srla_lpc_synthesize.c:237-327.)
"""

from __future__ import annotations

import numpy as np


def _half_const(rshifts: np.ndarray) -> np.ndarray:
    """C's ``1 << (rshift - 1)``; rshift==0 hits x86 shift-count masking and
    yields 1 << 31, i.e. 0x80000000 (mod 2^32 — sign is irrelevant here)."""
    rs = rshifts.astype(np.int64)
    return np.where(rs > 0, np.int64(1) << np.maximum(rs - 1, 0),
                    np.int64(0x80000000))


def lpc_predict(data: np.ndarray, coefs: np.ndarray, orders: np.ndarray,
                rshifts: np.ndarray) -> np.ndarray:
    """Batched forward prediction.

    data: (B, n) int32 input signal; coefs: (B, maxorder) int32 left-aligned
    (already order-reversed for forward convolution); orders: (B,);
    rshifts: (B,). Returns residual (B, n) int32. Blocks with order 0 copy.

    residual[s] = data[s] - data[s-1]                        for 1 <= s < order
    residual[s+order] = data[s+order]
                        + ((half + sum_i coef[i]*data[s+i]) >> rshift)
    """
    B, n = data.shape
    maxorder = coefs.shape[1]
    from .. import native_decoder
    if native_decoder.available():
        return native_decoder.lpc_predict_batch(data, coefs, orders, rshifts)
    x64 = data.astype(np.int64)
    residual = data.astype(np.int32).copy()

    # Right-align each block's coefficients so that column j multiplies
    # data[s + j - (maxorder - order)]; with left zero-padding of data by
    # maxorder the window math is uniform across blocks.
    ar = np.arange(maxorder)
    shift_amt = (maxorder - orders)[:, None]
    cols = ar[None, :] - shift_amt
    aligned = np.where(cols >= 0, np.take_along_axis(
        coefs, np.clip(cols, 0, maxorder - 1), axis=1), 0).astype(np.int64)

    padded = np.zeros((B, n + maxorder), dtype=np.int64)
    padded[:, maxorder:] = x64
    # windows[s] = padded[s .. s+maxorder-1] predicts sample s (0-based in data
    # coords: target index s corresponds to C's smpl+order with left alignment).
    win = np.lib.stride_tricks.sliding_window_view(padded, maxorder, axis=1)[:, :n]
    acc = np.einsum("bsk,bk->bs", win, aligned)
    with np.errstate(over="ignore"):
        half = _half_const(rshifts)[:, None]
        pred32 = (acc + half).astype(np.int32) >> rshifts[:, None].astype(np.int32)
        full = (residual + pred32).astype(np.int32)

    smpl_idx = np.arange(n)[None, :]
    ordv = orders[:, None]
    first_diff = np.empty_like(residual)
    first_diff[:, 0] = data[:, 0]
    with np.errstate(over="ignore"):
        first_diff[:, 1:] = (data[:, 1:].astype(np.int32)
                             - data[:, :-1].astype(np.int32))
    out = np.where(ordv == 0, residual,
                   np.where(smpl_idx < ordv,
                            np.where(smpl_idx == 0, residual, first_diff),
                            full))
    return out.astype(np.int32)


def lpc_synthesize(data: np.ndarray, coefs: np.ndarray, orders: np.ndarray,
                   rshifts: np.ndarray, num_samples: int) -> np.ndarray:
    """Batched in-order synthesis (inverse of lpc_predict), sequential in s.

    data: (B, n) int32 residuals; returns reconstructed (B, n) int32.
    """
    B, n = data.shape
    maxorder = coefs.shape[1]
    out = np.zeros((B, n + maxorder), dtype=np.int64)
    out[:, maxorder:] = data.astype(np.int64)

    ar = np.arange(maxorder)
    shift_amt = (maxorder - orders)[:, None]
    cols = ar[None, :] - shift_amt
    aligned = np.where(cols >= 0, np.take_along_axis(
        coefs, np.clip(cols, 0, maxorder - 1), axis=1), 0).astype(np.int64)

    ordv = orders.astype(np.int64)
    half = _half_const(rshifts)
    rs = rshifts.astype(np.int64)
    active = ordv > 0
    with np.errstate(over="ignore"):
        for s in range(1, num_samples):
            window = out[:, s:s + maxorder]
            acc = (window * aligned).sum(axis=1)
            pred = ((acc + half).astype(np.int32) >> rs.astype(np.int32)).astype(np.int64)
            cur = out[:, s + maxorder]
            prev = out[:, s + maxorder - 1]
            prologue = cur + prev           # first `order` samples: cumsum
            main = cur - pred
            newval = np.where(s < ordv, prologue, main)
            out[:, s + maxorder] = np.where(active,
                                            newval.astype(np.int32), cur)
    return out[:, maxorder:maxorder + n].astype(np.int32)


def ltp_predict(data: np.ndarray, coefs: np.ndarray, order: int,
                periods: np.ndarray, rshift: int) -> np.ndarray:
    """Batched long-term prediction. data (B, n) int32; coefs (B, order) int32
    (reversed); periods (B,) int32 (0 = disabled).

    residual[s] = data[s] - ((half + sum_i coef[i]*data[s - period - order//2 + i]) >> rshift)
    for s >= period + order//2 + 1.
    """
    B, n = data.shape
    from .. import native_decoder
    if native_decoder.available():
        return native_decoder.ltp_predict_batch(data, coefs, order, periods,
                                                rshift)
    # Vectorized fallback: the prediction source is the ORIGINAL data (no
    # recurrence), so all rows and samples compute at once via clipped
    # gathers; rows with period 0 and the first delay+1 samples pass through.
    half_order = order >> 1
    x = data.astype(np.int64)
    half = np.int64(1 << (rshift - 1))
    delay = periods.astype(np.int64)[:, None] + half_order
    s = np.arange(n, dtype=np.int64)[None, :]
    acc = np.full((B, n), half, dtype=np.int64)
    for i in range(order):
        idx = np.clip(s - delay + i, 0, max(n - 1, 0))
        acc += (coefs[:, i].astype(np.int64)[:, None]
                * np.take_along_axis(x, idx, axis=1))
    with np.errstate(over="ignore"):
        pred = acc.astype(np.int32) >> rshift
        out = (data.astype(np.int32) - pred).astype(np.int32)
    mask = (periods[:, None] > 0) & (s >= delay + 1)
    return np.where(mask, out, data.astype(np.int32))


def ltp_synthesize(data: np.ndarray, coefs: np.ndarray, orders: np.ndarray,
                   periods: np.ndarray, rshift: int) -> np.ndarray:
    """Inverse LTP (sequential recurrence; delay >= 9 so chunks of `delay-order`
    samples can be reconstructed at once — the window never overlaps the chunk).
    """
    B, n = data.shape
    out = data.astype(np.int32).copy()
    half = np.int64(1 << (rshift - 1))
    with np.errstate(over="ignore"):
        for b in range(B):
            per = int(periods[b])
            order = int(orders[b])
            if per == 0 or order == 0:
                continue
            half_order = order >> 1
            delay = per + half_order
            start = delay + 1
            x = out[b].astype(np.int64)
            # window for sample s covers [s-delay, s-delay+order-1]; the
            # farthest forward reach is s - delay + order - 1 < s, so samples
            # [s0, s0 + delay - order + 1) can be computed together.
            step = delay - order + 1
            s0 = start
            while s0 < n:
                s1 = min(n, s0 + step)
                s = np.arange(s0, s1)
                acc = np.full(s1 - s0, half, dtype=np.int64)
                for i in range(order):
                    acc += int(coefs[b, i]) * x[s - delay + i]
                pred = acc.astype(np.int32) >> rshift
                out[b, s0:s1] = (out[b, s0:s1] + pred).astype(np.int32)
                x[s0:s1] = out[b, s0:s1]
                s0 = s1
    return out
