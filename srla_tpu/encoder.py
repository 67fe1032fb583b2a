"""SRLA encoder — block-batched host-exact pipeline.

Architecture: unlike the sample-serial reference, analysis here is *batched
over blocks* — every stage (pre-emphasis stats, windowing, FFT autocorrelation,
Levinson-Durbin, order selection, quantization, integer FIR, Rice cost search)
runs as vectorized array code over all blocks of equal size at once, staying
bit-compatible with the reference stream. The JAX device path reuses this
exact structure (see srla_tpu/kernels/).

API parity targets: SRLAEncoder_* in libs/srla_encoder/src/srla_encoder.c.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from . import rice
from .bitio import BitWriter, sint32_to_uint32
from .bitsplice import PayloadBuilder
from .constants import (LPC_COEFFICIENT_BITWIDTH, LPC_COEFFICIENT_ORDER_BITWIDTH,
                        LPC_RIDGE_REGULARIZATION_PARAMETER,
                        LTP_COEFFICIENT_BITWIDTH, LTP_MAX_PERIOD, LTP_MIN_PERIOD,
                        LTP_ORDER_BITWIDTH, LTP_PERIOD_BITWIDTH,
                        PARAMETER_PRESETS,
                        PREEMPHASIS_COEF_SHIFT, RSHIFT_LPC_COEFFICIENT_BITWIDTH,
                        BlockDataType, ChProcessMethod, OrderTactics)
from .dsp import preemphasis as preemph
from .dsp.autocorr import autocorr_fft
from .dsp.fft import round_up_pow2
from .dsp.levinson import levinson_coefs_at, levinson_error_vars
from .dsp.pitch import calculate_ltp_coefficients
from .dsp.predict import lpc_predict, ltp_predict
from .dsp.quantize import quantize_coefficients
from .dsp.window import welch_window
from .format import StreamHeader, encode_header, frame_block
from .huffman import parameter_codebook, sum_parameter_codebook

_INV_LOGE2 = 1.4426950408889634
_FLT_MAX = 3.402823466e38


@dataclass
class EncodeParameter:
    num_channels: int
    bits_per_sample: int
    sampling_rate: int
    preset: int = 4
    max_num_samples_per_block: int = 4096
    min_num_samples_per_block: int = 4096
    num_lookahead_samples: int = 16384
    ltp_order: int = 0
    num_svr_filter_learning_iteration: int = 0

    def validate(self):
        if self.bits_per_sample not in (8, 16, 24):
            raise ValueError("bits_per_sample must be 8, 16, or 24")
        if self.min_num_samples_per_block > self.max_num_samples_per_block:
            raise ValueError("min block > max block")
        if self.num_lookahead_samples < self.max_num_samples_per_block:
            raise ValueError("lookahead < max block")
        if self.num_lookahead_samples % self.min_num_samples_per_block != 0:
            raise ValueError("lookahead not divisible by min block")
        if self.ltp_order > 0 and self.ltp_order % 2 == 0:
            raise ValueError("ltp order must be odd")
        if self.ltp_order > 3:
            raise ValueError("ltp order too large")


@dataclass
class _ChannelParams:
    """Per-(block, channel-variant) analysis results, batched over blocks."""
    pre_prev: np.ndarray      # (B,) int32 — transmitted pre-emphasis prev
    pre_coef: np.ndarray      # (B,) int32
    lpc_order: np.ndarray     # (B,) int32
    lpc_rshift: np.ndarray    # (B,) int32
    lpc_coefs: np.ndarray     # (B, maxorder) int32, reversed, left-aligned
    use_sum_coef: np.ndarray  # (B,) bool
    ltp_period: np.ndarray    # (B,) int32 (0 = off)
    ltp_coefs: np.ndarray     # (B, ltp_order) int32, reversed
    residual: np.ndarray      # (B, n) int32
    code_length: np.ndarray   # (B,) int64 bits (everything but stereo flag)
    rice_type: np.ndarray     # (B,) int32 CodeType
    rice_porder: np.ndarray   # (B,) int32
    rice_ks: np.ndarray       # (B, 1024) int16 per-partition parameters

    def rows(self):
        return [getattr(self, f) for f in self.__dataclass_fields__]


def _geometric_entropy_scalar(mabse: float, bps: int) -> float:
    if mabse < 1e-16:
        return 0.0
    intmean = mabse * (1 << (bps - 1))
    rho = 1.0 / (1.0 + intmean)
    invrho = 1.0 - rho
    return -(invrho * (math.log(invrho) * _INV_LOGE2)
             + rho * (math.log(rho) * _INV_LOGE2)) / rho


def _slice_params(p: _ChannelParams, lo: int, hi: int) -> _ChannelParams:
    return _ChannelParams(*[f[lo:hi] for f in p.rows()])


class _DaemonTask:
    """Run fn on a DAEMON thread with a cf.Future-like ``result(timeout)``.

    The hybrid scheduler's device worker can block inside a jax device op,
    and jax offers no cancellation. concurrent.futures threads are
    non-daemon and joined at interpreter exit, so a hung worker would hang
    the whole process AFTER the encode already completed via host racing.
    Daemon threads are simply abandoned.
    """

    def __init__(self, fn):
        import threading
        self._done = threading.Event()
        self._exc = None

        def run():
            try:
                fn()
            except BaseException as e:  # surfaced via result()
                self._exc = e
            finally:
                self._done.set()

        t = threading.Thread(target=run, daemon=True,
                             name="srla-dev-worker")
        t.start()

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise TimeoutError
        if self._exc is not None:
            raise self._exc
        return None


class SRLAEncoder:
    def __init__(self, parameter: EncodeParameter, backend: str = "exact",
                 mesh=None):
        parameter.validate()
        self.p = parameter
        import os
        # Device analysis modes:
        #  - exact (default): df64 analysis + boundary flagging
        #    (kernels/exact.py) — decisions provably equal the f64 host
        #    oracle, output byte-identical to the reference and
        #    deterministic. Covers the full flag set on device, including
        #    LTP (-P) and SVR refinement (kernels/exact.py _ltp_exact /
        #    _svr_exact, exercised by tests/test_golden_tpu.py); remaining
        #    host routing (odd tails, tiny groups) is counted in self.stats.
        #  - approx (SRLA_TPU_APPROX=1): the f32 fast path
        #    (kernels/encode.py) — lossless but not reference-byte-exact and
        #    not run-reproducible; covers LTP on device.
        self._approx_device = os.environ.get("SRLA_TPU_APPROX", "") == "1"
        if backend == "tpu" and self._approx_device \
                and parameter.ltp_order > 0 \
                and parameter.min_num_samples_per_block \
                != parameter.max_num_samples_per_block:
            # The approx fast path covers LTP for fixed-size blocks only.
            backend = "exact"
        self.backend = backend
        self._device_exact_ok = parameter.bits_per_sample <= 24
        # Per-encode capability/fallback accounting (no silent capability
        # holes: every block that falls back to the host is counted here).
        self.stats = {"device_blocks": 0, "host_blocks": 0,
                      "repaired_blocks": 0, "w_overflow_blocks": 0,
                      "device_unsupported_config": (
                          backend == "tpu" and not self._approx_device
                          and not self._device_exact_ok)}
        # Optional jax.sharding.Mesh: device analysis inputs are placed with
        # the block axis sharded over it (multi-chip block parallelism).
        self.mesh = mesh
        self.preset = PARAMETER_PRESETS[parameter.preset]
        self._param_cb = parameter_codebook()
        self._sum_cb = sum_parameter_codebook()
        self._param_lens = self._param_cb.lengths
        self._sum_lens = self._sum_cb.lengths

    # ------------------------------------------------------------------ #
    # Per-channel analysis pipeline (batched over blocks of equal length) #
    # ------------------------------------------------------------------ #

    def _analyze_channel(self, sig: np.ndarray, n: int, stale_state=None,
                         want_state: bool = False):
        """Batched per-channel analysis. `stale_state` emulates the
        reference's persistent LPC work buffer (needed for bit-exactness of
        odd-length blocks, whose Welch window leaves the middle sample
        unwritten); serial callers (B=1) thread it between variants and get
        the new state back when `want_state` is set."""
        B = sig.shape[0]
        bps = self.p.bits_per_sample
        max_params = self.preset.max_num_parameters
        state = stale_state

        # 1. Pre-emphasis: coefficient, then in-place filter with prev = head.
        pre_coef = preemph.calculate_coefficient(sig, n)
        head = sig[:, 0].copy()
        work = preemph.preemphasis(sig[:, :n], pre_coef, head)

        # 2. Long-term (pitch) prediction.
        ltp_order = self.p.ltp_order
        ltp_period = np.zeros(B, dtype=np.int32)
        ltp_coefs = np.zeros((B, max(ltp_order, 1)), dtype=np.int32)
        if ltp_order > 0:
            norm = 2.0 ** (-(bps - 1))
            max_lag = LTP_MAX_PERIOD + 1
            if n == 1:
                # Degenerate 1-sample tail: the whole signal is the Welch
                # window's unwritten middle, and the size-1 real FFT mixes
                # it with stale buffer[1] (fft.c:147-198 with n=1).
                s0 = 0.0 if state is None else float(state[0])
                s1 = 0.0 if state is None else float(state[1])
                b0, b1 = s0 + s1, s0 - s1
                c0, c1 = b0 * b0, b1 * b1
                y0, y1 = 0.5 * (c0 + c1), 0.5 * (c0 - c1)
                base = (np.zeros(max_lag) if state is None
                        else state[:max_lag].astype(np.float64).copy())
                base[0] = y0
                if max_lag > 1:
                    base[1] = y1
                ac = np.broadcast_to(base * 2.0, (B, max_lag)).copy()
                if want_state:
                    ns = (state.copy() if state is not None
                          else np.zeros(2))
                    ns[0] = y0
                    ns[1] = y1
                    state = ns
            else:
                win = welch_window(n)
                fft_size = round_up_pow2(n)
                from . import native_decoder as _pnd
                if _pnd.available() and not want_state:
                    # Fused native normalize+window+FFT (AVX2 4-lane SoA
                    # when batched) — same rounding chain as the numpy
                    # path below, already golden-validated for the LPC
                    # autocorrelation.
                    mid = 0.0 if state is None else float(state[n // 2])
                    ac = _pnd.window_autocorr_batch(
                        work, n, norm, win, bool(n & 1), mid, fft_size,
                        max_lag)
                else:
                    dbl = work.astype(np.float64) * norm
                    windowed = dbl * win
                    if n & 1:
                        windowed[:, n // 2] = (0.0 if state is None
                                               else state[n // 2])
                    ac, raw = autocorr_fft(windowed, n, max_lag,
                                           want_raw=True)
                if max_lag > fft_size and state is not None:
                    # The reference reads stale buffer content for lags
                    # beyond the FFT size (tiny tail blocks with LTP).
                    ac[:, fft_size:] = state[fft_size:max_lag] * (2.0 / n)
                if want_state:
                    ns = state.copy() if state is not None else np.zeros(
                        max(len(raw[0]), n))
                    ns[:raw.shape[1]] = raw[0]
                    state = ns
            acbuf = np.zeros((B, LTP_MAX_PERIOD + 3))
            acbuf[:, :max_lag] = ac
            from . import native_decoder as _ltp_nd
            if _ltp_nd.available():
                ltp_period, ltp_coefs = _ltp_nd.ltp_analyze_batch(
                    acbuf, ltp_order, LTP_MIN_PERIOD, LTP_MAX_PERIOD,
                    LPC_RIDGE_REGULARIZATION_PARAMETER)
            else:
                for b in range(B):
                    coef, period = calculate_ltp_coefficients(
                        acbuf[b], ltp_order, LTP_MIN_PERIOD, LTP_MAX_PERIOD,
                        LPC_RIDGE_REGULARIZATION_PARAMETER)
                    if period > 0:
                        q = np.where(coef >= 0, np.floor(coef * 32.0 + 0.5),
                                     -np.floor(-coef * 32.0 + 0.5))
                        q = np.clip(q, -32, 31).astype(np.int32)
                        ltp_coefs[b] = q[::-1]
                        ltp_period[b] = period
            if (ltp_period > 0).any():
                filtered = ltp_predict(work, ltp_coefs, ltp_order, ltp_period,
                                       LTP_COEFFICIENT_BITWIDTH - 1)
                work = np.where((ltp_period > 0)[:, None], filtered, work)

        # 3..9. LPC analysis chain.
        orders = np.zeros(B, dtype=np.int32)
        rshifts = np.zeros(B, dtype=np.int32)
        int_coefs = np.zeros((B, max(max_params, 1)), dtype=np.int32)
        if max_params > 0:
            norm = 2.0 ** (-(bps - 1))
            win = welch_window(n)
            from . import native_decoder as _nd
            dbl = None
            if _nd.available():
                # Fused native path: normalize+window+pad+FFT in one pass.
                mid = 0.0 if state is None else float(state[n // 2])
                if want_state:
                    ac, raw = _nd.window_autocorr_batch(
                        work, n, norm, win, bool(n & 1), mid,
                        round_up_pow2(n), max_params + 1, want_raw=True)
                    # Preserve the work buffer's stale TAIL beyond this
                    # FFT's length — tiny spans' LTP lag patches read it.
                    ns = (state.copy() if state is not None
                          else np.zeros(max(raw.shape[1], n)))
                    ns[:raw.shape[1]] = raw[0]
                    state = ns
                else:
                    ac = _nd.window_autocorr_batch(
                        work, n, norm, win, bool(n & 1), mid,
                        round_up_pow2(n), max_params + 1)
            else:
                dbl = work.astype(np.float64) * norm
                windowed = dbl * win
                if n & 1:
                    windowed[:, n // 2] = (0.0 if state is None
                                           else state[n // 2])
                if want_state:
                    ac, raw = autocorr_fft(windowed, n, max_params + 1,
                                           want_raw=True)
                    ns = (state.copy() if state is not None
                          else np.zeros(max(raw.shape[1], n)))
                    ns[:raw.shape[1]] = raw[0]
                    state = ns
                else:
                    ac = autocorr_fft(windowed, n, max_params + 1)
            ac[:, 0] = ac[:, 0] * (1.0 + LPC_RIDGE_REGULARIZATION_PARAMETER)
            error_vars, _ = levinson_error_vars(ac, max_params)
            # Window energy correction (applied before order selection).
            from .dsp.window import welch_inverse_squared_sum
            error_vars = error_vars * welch_inverse_squared_sum(n)
            orders = self._select_order(error_vars, n, max_params)
            coefs_f = levinson_coefs_at(ac, max_params, orders)
            # (SVR refinement hook: num_svr_filter_learning_iteration > 0.)
            if self.p.num_svr_filter_learning_iteration > 0:
                if dbl is None:
                    dbl = work.astype(np.float64) * norm
                coefs_f, svr_bufs = self._svr_refine(dbl, coefs_f, orders, n)
                if want_state and svr_bufs[0] is not None:
                    # The reference's SVR writes its soft-thresholded
                    # residuals into the persistent work buffer; thread it.
                    ns = (state.copy() if state is not None
                          else np.zeros(max(n, 2)))
                    ns[:n] = svr_bufs[0]
                    state = ns
            int_coefs, rshifts = quantize_coefficients(
                coefs_f, orders, LPC_COEFFICIENT_BITWIDTH,
                1 << RSHIFT_LPC_COEFFICIENT_BITWIDTH)
            rshifts = np.where(orders > 0, rshifts, 0).astype(np.int32)
            # Reverse for forward-indexed convolution.
            rev = np.zeros_like(int_coefs)
            for b in range(B):
                o = int(orders[b])
                if o:
                    rev[b, :o] = int_coefs[b, :o][::-1]
            int_coefs = rev
            residual = lpc_predict(work, int_coefs, orders, rshifts)
        else:
            # Order 0: the pre-emphasis (or LTP) output IS the residual.
            # Both producers return fresh buffers, so aliasing is safe —
            # a copy here cost ~40% of the -m 0 -V span-measurement time.
            residual = work

        # 13. Exact bit accounting (vectorized over the batch).
        rice_type, rice_porder, rice_bits, rice_ks = rice.analyze_batch(
            residual[:, :n], n)
        code_length, use_sum = self._account_bits(
            rice_bits, orders, int_coefs, ltp_period, ltp_order)
        params = _ChannelParams(head.astype(np.int32), pre_coef, orders,
                                rshifts, int_coefs, use_sum, ltp_period,
                                ltp_coefs, residual, code_length, rice_type,
                                rice_porder, rice_ks)
        if want_state:
            return params, state
        return params

    def _account_bits(self, rice_bits, orders, int_coefs, ltp_period,
                      ltp_order):
        """Exact per-channel bit accounting, vectorized (everything except
        the stereo method field). Parity: srla_encoder.c:1121-1187."""
        bps = self.p.bits_per_sample
        plens = self._param_lens
        slens = self._sum_lens
        B, M = int_coefs.shape
        from . import native_decoder as _nd
        if _nd.available():
            fixed = (bps + 1 + (PREEMPHASIS_COEF_SHIFT + 1)
                     + LPC_COEFFICIENT_ORDER_BITWIDTH
                     + RSHIFT_LPC_COEFFICIENT_BITWIDTH + 1 + 1)
            ltp_bits = (LTP_ORDER_BITWIDTH + LTP_PERIOD_BITWIDTH
                        + ltp_order * LTP_COEFFICIENT_BITWIDTH)
            return _nd.account_bits_batch(rice_bits, orders, int_coefs,
                                          ltp_period, ltp_bits, plens,
                                          slens, fixed)
        mask = np.arange(M)[None, :] < orders[:, None]
        uv = sint32_to_uint32(int_coefs)
        coef_cost = np.where(mask, plens[uv], 0).sum(axis=1)
        summed = (int_coefs[:, 1:].astype(np.int64)
                  + int_coefs[:, :-1].astype(np.int64)).astype(np.int32)
        suv = sint32_to_uint32(summed)
        smask = mask[:, 1:]
        svalid = (~smask | (suv < 256)).all(axis=1)
        sum_cost = (plens[uv[:, 0]]
                    + np.where(smask, slens[np.minimum(suv, 255)], 0).sum(axis=1))
        # use_sum starts set and is only cleared while scanning; order-1
        # blocks therefore keep it (identical cost either way).
        use_sum = (orders > 0) & svalid & ((orders == 1)
                                           | (sum_cost < coef_cost))
        coef_bits = np.where(orders > 0,
                             np.where(use_sum, sum_cost, coef_cost), 0)
        code_length = (rice_bits.astype(np.int64)
                       + bps + 1 + (PREEMPHASIS_COEF_SHIFT + 1)
                       + LPC_COEFFICIENT_ORDER_BITWIDTH
                       + RSHIFT_LPC_COEFFICIENT_BITWIDTH + 1
                       + coef_bits + 1
                       + np.where(ltp_period > 0,
                                  LTP_ORDER_BITWIDTH + LTP_PERIOD_BITWIDTH
                                  + ltp_order * LTP_COEFFICIENT_BITWIDTH, 0))
        return code_length.astype(np.int64), use_sum

    # ------------------------------------------------------------------ #
    # Block-level encoding                                                #
    # ------------------------------------------------------------------ #

    def _select_order(self, error_vars: np.ndarray, n: int,
                      max_params: int) -> np.ndarray:
        """Order selection per block (BRUTEFORCE_ESTIMATION or MAX_FIXED).

        Vectorized entropy estimate with scalar-libm re-evaluation whenever
        the top two candidates are too close to trust np.log's last ulp.
        """
        B = error_vars.shape[0]
        if self.preset.lpc_order_tactics == OrderTactics.MAX_FIXED:
            return np.full(B, max_params, dtype=np.int32)
        bps = self.p.bits_per_sample
        from . import native_decoder as _nd
        if _nd.available():
            # Single-pass native twin: plain libm log/sqrt IS the scalar
            # repair chain below, so coarse+repair collapses to one loop.
            return _nd.select_orders_batch(error_vars, n, bps, max_params,
                                           LPC_COEFFICIENT_BITWIDTH)
        with np.errstate(invalid="ignore", divide="ignore"):
            mabse = 2.0 * np.sqrt(error_vars[:, 1:] / 2.0)
            intmean = mabse * float(1 << (bps - 1))
            rho = 1.0 / (1.0 + intmean)
            invrho = 1.0 - rho
            ent = -(invrho * (np.log(invrho) * _INV_LOGE2)
                    + rho * (np.log(rho) * _INV_LOGE2)) / rho
            ent = np.where(mabse < 1e-16, 0.0, ent)
            length = (ent * n + LPC_COEFFICIENT_BITWIDTH
                      * np.arange(1, max_params + 1)[None, :])
        safe = np.where(np.isnan(length), np.inf, length)
        orders = (np.argmin(safe, axis=1) + 1).astype(np.int32)
        # Tie repair: re-evaluate blocks whose best two lengths are within
        # 1e-6 bits using the exact libm chain.
        part = np.partition(safe, 1, axis=1) if safe.shape[1] > 1 else None
        if part is not None:
            risky = np.flatnonzero(np.abs(part[:, 1] - part[:, 0]) < 1e-6)
            for b in risky:
                minlen = _FLT_MAX
                best = 0
                for order in range(1, max_params + 1):
                    ev = error_vars[b, order]
                    if not ev >= 0.0:  # NaN/negative: never selected (C NaN)
                        continue
                    mab = 2.0 * math.sqrt(ev / 2.0)
                    ln = (_geometric_entropy_scalar(mab, bps) * n
                          + LPC_COEFFICIENT_BITWIDTH * order)
                    if minlen > ln:
                        minlen = ln
                        best = order
                if best > 0:
                    orders[b] = best
        return orders

    def _svr_refine(self, dbl, coefs_f, orders, n):
        from .dsp.svr import svr_refine_batch
        return svr_refine_batch(dbl, coefs_f, orders, n,
                                self.p.num_svr_filter_learning_iteration,
                                self.p.bits_per_sample,
                                LPC_RIDGE_REGULARIZATION_PARAMETER,
                                self.preset.margin_list)

    def _compute_coefficients(self, blocks: np.ndarray, n: int,
                              offset_lshift: int, stale_state=None,
                              measure_only: bool = False):
        """blocks: (B, C, n) int32 raw samples. Returns (method (B,),
        params per output channel list[C] of _ChannelParams, bits (B,)).
        With `measure_only`, params is None — the per-channel merge (which
        copies residual-sized arrays) is skipped; only the decision-exact
        bit counts are produced (the -V span-measurement hot path)."""
        B, C, _ = blocks.shape
        work = _apply_lshift(blocks, offset_lshift)

        # Stack all channel variants ([M, S] + plain channels) into ONE
        # batched analysis call.
        variants = []
        if C >= 2:
            s = (work[:, 1] - work[:, 0]).astype(np.int32)
            m = (work[:, 0] + (s >> 1)).astype(np.int32)
            variants.extend([m, s])
        variants.extend(work[:, c] for c in range(C))
        if stale_state is not None:
            # Serial (B=1) flow threading the reference's persistent LPC
            # work-buffer state between channel variants (odd-length blocks).
            assert B == 1
            split = []
            state = stale_state
            for v in variants:
                params, raw = self._analyze_channel(v, n, stale_state=state,
                                                    want_state=True)
                if raw is not None:
                    state = state.copy()
                    state[:len(raw)] = raw
                split.append(params)
            self._last_state = state
        else:
            stack = np.ascontiguousarray(np.concatenate(variants, axis=0))
            all_params = self._analyze_channel(stack, n)
            split = [_slice_params(all_params, i * B, (i + 1) * B)
                     for i in range(len(variants))]
        if C >= 2:
            ms_params = split[:2]
            ch_params = split[2:]
        else:
            ms_params = None
            ch_params = split

        if C == 1:
            method = np.zeros(B, dtype=np.int32)
            bits = ch_params[0].code_length.copy()
            out_params = ch_params
        else:
            l0 = ch_params[0].code_length
            l1 = ch_params[1].code_length
            m0 = ms_params[0].code_length
            m1 = ms_params[1].code_length
            lens = np.stack([l0 + l1, m0 + m1, l0 + m1, l1 + m1])  # NONE,MS,LS,SR
            method = np.argmin(lens, axis=0).astype(np.int32)  # first min wins
            bits = lens[method, np.arange(B)]
            out_params = (None if measure_only else
                          [self._merge_params(ch_params, ms_params, method,
                                              c, B) for c in range(C)])
        bits = bits + 2
        bits = ((bits + 7) // 8) * 8
        return method, out_params, bits

    @staticmethod
    def _merge_params(ch_params, ms_params, method, c, B):
        """Select per-block between plain and MS variants for channel c."""
        if c >= 2:
            return ch_params[c]
        base = ch_params[c]
        # Per-block source table (vectorized): channel 0 takes the mid
        # variant under MS and the side variant under SR; channel 1 takes
        # the side variant under MS and LS; everything else stays plain.
        if c == 0:
            picks = [(method == int(ChProcessMethod.MS), ms_params[0]),
                     (method == int(ChProcessMethod.SR), ms_params[1])]
        else:
            picks = [((method == int(ChProcessMethod.MS))
                      | (method == int(ChProcessMethod.LS)), ms_params[1])]
        picks = [(m, src) for m, src in picks if m.any()]
        if not picks:
            return base
        fields = []
        for f in base.__dataclass_fields__:
            arr = np.copy(getattr(base, f))
            for mask, src in picks:
                arr[mask] = getattr(src, f)[mask]
            fields.append(arr)
        return _ChannelParams(*fields)

    def _compress_payload(self, params, method_b: int, n: int, b: int,
                          C: int) -> bytes:
        """Assemble one block's compress payload from batched params."""
        bps = self.p.bits_per_sample
        from . import native_decoder
        if native_decoder.available():
            ltp_o = self.p.ltp_order
            has_ltp = ltp_o > 0
            payload, bits = native_decoder.emit_payload(
                C, bps, n, method_b,
                [int(p.pre_prev[b]) for p in params],
                [int(p.pre_coef[b]) for p in params],
                [int(p.lpc_order[b]) for p in params],
                [int(p.lpc_rshift[b]) for p in params],
                [1 if p.use_sum_coef[b] else 0 for p in params],
                np.stack([p.lpc_coefs[b] for p in params]),
                ltp_o if has_ltp else 1,
                [int(p.ltp_period[b]) for p in params] if has_ltp else None,
                np.stack([p.ltp_coefs[b] for p in params]) if has_ltp
                else None,
                np.stack([p.residual[b, :n] for p in params]),
                [int(p.rice_type[b]) for p in params],
                [int(p.rice_porder[b]) for p in params],
                [p.rice_ks[b] for p in params])
            if payload is not None:
                return payload
        w = BitWriter()
        w.put(method_b, 2)
        for c in range(C):
            pp = params[c]
            w.put(int(sint32_to_uint32(np.int32(pp.pre_prev[b]))), bps + 1)
            w.put(int(sint32_to_uint32(np.int32(pp.pre_coef[b]))),
                  PREEMPHASIS_COEF_SHIFT + 1)
        for c in range(C):
            pp = params[c]
            o = int(pp.lpc_order[b])
            w.put(o, LPC_COEFFICIENT_ORDER_BITWIDTH)
            w.put(int(pp.lpc_rshift[b]), RSHIFT_LPC_COEFFICIENT_BITWIDTH)
            w.put(1 if pp.use_sum_coef[b] else 0, 1)
            if o > 0:
                coefs = pp.lpc_coefs[b, :o]
                uv = sint32_to_uint32(coefs)
                if not pp.use_sum_coef[b]:
                    w.put(self._param_cb.codes[uv], self._param_lens[uv])
                else:
                    w.put(int(self._param_cb.codes[uv[0]]),
                          int(self._param_lens[uv[0]]))
                    summed = (coefs[1:].astype(np.int64)
                              + coefs[:-1].astype(np.int64)).astype(np.int32)
                    suv = sint32_to_uint32(summed)
                    w.put(self._sum_cb.codes[suv], self._sum_lens[suv])
        for c in range(C):
            pp = params[c]
            per = int(pp.ltp_period[b])
            w.put(1 if per else 0, 1)
            if per:
                w.put((self.p.ltp_order - 1) // 2, LTP_ORDER_BITWIDTH)
                w.put(per - LTP_MIN_PERIOD, LTP_PERIOD_BITWIDTH)
                uv = sint32_to_uint32(pp.ltp_coefs[b])
                w.put(uv.astype(np.uint64),
                      np.full(self.p.ltp_order, LTP_COEFFICIENT_BITWIDTH))
        for c in range(C):
            pp = params[c]
            uvals = sint32_to_uint32(pp.residual[b, :n]).astype(np.int64)
            rice.emit_channel(w, uvals, n, int(pp.rice_type[b]),
                              int(pp.rice_porder[b]), pp.rice_ks[b])
        return w.getvalue()

    def _raw_payload(self, block: np.ndarray, n: int) -> bytes:
        """Channel-interleaved zigzag PCM at 8/16/24 bits BE."""
        bps = self.p.bits_per_sample
        uv = sint32_to_uint32(block[:, :n]).T  # (n, C)
        nbytes = bps // 8
        out = np.zeros((uv.shape[0], uv.shape[1], nbytes), dtype=np.uint8)
        for i in range(nbytes):
            out[:, :, i] = (uv >> (8 * (nbytes - 1 - i))).astype(np.uint8)
        return out.tobytes()

    # -- block-level public API (parity: srla_encoder.h) ----------------- #

    def encode_block(self, pcm_block: np.ndarray, offset_lshift: int = 0
                     ) -> bytes:
        """Encode one block (C, n) -> framed block bytes.

        Parity: SRLAEncoder_EncodeBlock (type decision, compress/raw/silent,
        raw fallback, checksum framing).
        """
        pcm_block = np.asarray(pcm_block, dtype=np.int32)
        n = pcm_block.shape[1]
        return self._encode_spans(pcm_block, [(0, n)], offset_lshift)[0]

    def compute_block_size(self, pcm_block: np.ndarray,
                           offset_lshift: int = 0) -> int:
        """Byte size this block would encode to (SRLAEncoder_ComputeBlockSize)."""
        pcm_block = np.asarray(pcm_block, dtype=np.int32)
        n = pcm_block.shape[1]
        return self._measure_blocks(pcm_block, [0], n, offset_lshift)[0]

    def encode_optimal_partitioned_block(self, pcm_window: np.ndarray,
                                         offset_lshift: int = 0) -> bytes:
        """Optimal-partition encode of one lookahead window
        (SRLAEncoder_EncodeOptimalPartitionedBlock)."""
        pcm_window = np.asarray(pcm_window, dtype=np.int32)
        span = pcm_window.shape[1]
        parts = self._search_partitions(pcm_window, span, offset_lshift)
        spans = []
        off = 0
        for size in parts:
            spans.append((off, size))
            off += size
        return b"".join(self._encode_spans(pcm_window, spans, offset_lshift))

    def _report_progress(self, nsamples: int) -> None:
        """Advance the per-encode progress meter (parity: the reference's
        EncodeBlockCallback, srla_encoder.c:1780). Fired per encoded chunk —
        the batched pipeline has no per-block serial point."""
        cb = getattr(self, "_progress_cb", None)
        if cb is None:
            return
        import threading
        lock = getattr(self, "_progress_lock", None)
        if lock is None:
            lock = self._progress_lock = threading.Lock()
        with lock:
            self._progress_done += nsamples
            done = self._progress_done
        try:
            cb(done)
        except Exception:
            self._progress_cb = None  # a broken callback never kills encode

    def encode_whole(self, pcm: np.ndarray, progress_callback=None) -> bytes:
        """pcm: (C, N) int32. Returns the complete .srl stream."""
        C, N = pcm.shape
        self._progress_cb = progress_callback
        self._progress_done = 0
        p = self.p
        offset_lshift = _compute_offset_lshift(pcm)
        header = StreamHeader(C, N, p.sampling_rate, p.bits_per_sample,
                              offset_lshift, p.max_num_samples_per_block,
                              p.preset)
        out = [encode_header(header)]

        if p.min_num_samples_per_block == p.max_num_samples_per_block:
            out.extend(self._encode_fixed(pcm, offset_lshift))
        else:
            out.extend(self._encode_variable(pcm, offset_lshift))
        self._check_repair_rate()
        return b"".join(out)

    # Boundary-flag (host repair) rate above which the encode is still
    # byte-exact but silently degrades toward host speed; make that mode
    # visible to operators instead of silent.
    _REPAIR_WARN_RATIO = 0.05

    def _check_repair_rate(self) -> None:
        dev = self.stats["device_blocks"] + self.stats["repaired_blocks"]
        rep = self.stats["repaired_blocks"]
        if dev == 0:
            return
        ratio = rep / dev
        self.stats["repair_ratio"] = round(ratio, 4)
        if ratio > self._REPAIR_WARN_RATIO:
            import warnings
            warnings.warn(
                f"srla_tpu: {rep}/{dev} device-analyzed blocks "
                f"({100 * ratio:.1f}%) hit df64 decision boundaries and were "
                "re-derived on the host; output is still byte-exact but "
                "encode throughput degrades toward host speed on this input.",
                RuntimeWarning, stacklevel=3)

    # -- fixed block path ------------------------------------------------ #

    def _encode_fixed(self, pcm: np.ndarray, offset_lshift: int) -> list[bytes]:
        C, N = pcm.shape
        n = self.p.max_num_samples_per_block
        spans = [(off, min(n, N - off)) for off in range(0, N, n)]
        return self._encode_spans(pcm, spans, offset_lshift)

    def _encode_spans(self, pcm: np.ndarray, spans, offset_lshift: int):
        """Encode a list of (offset, size) blocks, batching by equal size."""
        C = pcm.shape[0]
        results: dict[int, bytes] = {}
        # Classify block types.
        types = {}
        for i, (off, size) in enumerate(spans):
            blk = pcm[:, off:off + size]
            if size <= self.preset.max_num_parameters:
                types[i] = BlockDataType.RAW
            elif not blk.any():
                types[i] = BlockDataType.SILENT
            else:
                types[i] = BlockDataType.COMPRESS

        # Batch compress blocks by size.
        by_size: dict[int, list[int]] = {}
        for i, (off, size) in enumerate(spans):
            if types[i] == BlockDataType.COMPRESS:
                by_size.setdefault(size, []).append(i)
        C = pcm.shape[0]
        for size, idxs in by_size.items():
            # Equal-size groups go through the device pipeline (analysis +
            # residual packing on the device). Groups below the row
            # threshold stay host: the device handles ANY group size (tiny
            # groups reuse the same padded compile bucket — see
            # test_exact_device's min-group test), so routing stragglers
            # host-side is a latency policy, not a capability line.
            # SRLA_TPU_MIN_GROUP_ROWS=1 forces everything device-side.
            if self.backend == "tpu" \
                    and len(idxs) * max(C, 2) >= self._min_group_rows() \
                    and self._device_size_ok(size):
                results.update(self._encode_group_hybrid(
                    pcm, spans, idxs, size, offset_lshift))
                continue
            if size % 2 == 1:
                # Odd-length blocks: the reference's Welch window leaves the
                # middle sample holding stale work-buffer content — emulate
                # the buffer state chain serially per block.
                for i in idxs:
                    state = self._incoming_state(pcm, spans, types, i,
                                                 offset_lshift)
                    blocks = pcm[:, spans[i][0]:spans[i][0] + size][None]
                    method, params, _bits = self._compute_coefficients(
                        blocks.astype(np.int32), size, offset_lshift,
                        stale_state=state)
                    results[i] = self._finish_block(pcm, spans, i, size,
                                                    params, int(method[0]),
                                                    0, C)
                continue
            results.update(self._encode_host_batch(pcm, spans, idxs, size,
                                                   offset_lshift))
        for i, (off, size) in enumerate(spans):
            if types[i] == BlockDataType.SILENT:
                results[i] = frame_block(BlockDataType.SILENT, size, b"")
            elif types[i] == BlockDataType.RAW:
                blk = pcm[:, off:off + size]
                results[i] = frame_block(
                    BlockDataType.RAW, size,
                    self._raw_payload(blk.astype(np.int32), size))
        return [results[i] for i in range(len(spans))]

    def _encode_host_batch(self, pcm, spans, idxs, size, offset_lshift):
        """Host-native batched encode of even-size blocks.

        SRLA_HOST_THREADS > 1 splits the batch across a thread pool — the
        hot loops are native/numpy and release the GIL, so this scales with
        host cores (default 1)."""
        import os
        try:
            nthreads = int(os.environ.get("SRLA_HOST_THREADS", "1"))
        except ValueError:
            nthreads = 1
        if nthreads > 1 and len(idxs) >= 2 * nthreads:
            import concurrent.futures as cf
            shards = [list(idxs[j::nthreads]) for j in range(nthreads)]
            results: dict[int, bytes] = {}
            with cf.ThreadPoolExecutor(nthreads) as ex:
                futs = [ex.submit(self._encode_host_shard, pcm, spans, sh,
                                  size, offset_lshift) for sh in shards]
                for f in futs:
                    results.update(f.result())
            return results
        return self._encode_host_shard(pcm, spans, idxs, size, offset_lshift)

    def _encode_host_shard(self, pcm, spans, idxs, size, offset_lshift):
        C = pcm.shape[0]
        blocks = np.stack([pcm[:, spans[i][0]:spans[i][0] + size]
                           for i in idxs])
        method, params, _bits = self._compute_coefficients(
            blocks.astype(np.int32), size, offset_lshift)
        out = self._emit_host_batch(pcm, spans, idxs, size, method, params, C)
        self.stats["host_blocks"] += len(idxs)
        self._report_progress(len(idxs) * size)
        return out

    def _emit_host_batch(self, pcm, spans, idxs, size, method, params,
                         C) -> dict[int, bytes]:
        """Frame a host-analyzed batch. One native emit call covers every
        block (per-block emit_payload spent ~0.15 s in ctypes marshalling
        per 2 min of audio); rows it cannot represent (raw cheaper,
        coefficient outside the Huffman tables) fall back per block."""
        from . import native_decoder as nd
        B = len(idxs)
        if not nd.available():
            return {i: self._finish_block(pcm, spans, i, size, params,
                                          int(method[bi]), bi, C)
                    for bi, i in enumerate(idxs)}
        ltp_o = self.p.ltp_order
        stack = lambda f: np.stack([f(p) for p in params], axis=1)  # noqa
        framed, sizes = nd.emit_blocks_batch(
            C, self.p.bits_per_sample, size, np.asarray(method)[:B],
            stack(lambda p: p.pre_prev), stack(lambda p: p.pre_coef),
            stack(lambda p: p.lpc_order), stack(lambda p: p.lpc_rshift),
            stack(lambda p: p.use_sum_coef.astype(np.int32)),
            np.stack([p.lpc_coefs for p in params], axis=1),
            ltp_o if ltp_o > 0 else 1,
            stack(lambda p: p.ltp_period) if ltp_o > 0 else None,
            np.stack([p.ltp_coefs for p in params], axis=1)
            if ltp_o > 0 else None,
            [p.residual[:, :size] for p in params],
            [p.rice_ks for p in params],
            stack(lambda p: p.rice_type), stack(lambda p: p.rice_porder))
        if framed is None:
            return {i: self._finish_block(pcm, spans, i, size, params,
                                          int(method[bi]), bi, C)
                    for bi, i in enumerate(idxs)}
        out: dict[int, bytes] = {}
        off = 0
        for bi, i in enumerate(idxs):
            sz = int(sizes[bi])
            if sz > 0:
                out[i] = framed[off:off + sz]
                off += sz
            elif sz == 0:
                blk = pcm[:, spans[i][0]:spans[i][0] + size]
                out[i] = frame_block(
                    BlockDataType.RAW, size,
                    self._raw_payload(blk.astype(np.int32), size))
            else:
                out[i] = self._finish_block(pcm, spans, i, size, params,
                                            int(method[bi]), bi, C)
        return out

    # Hybrid scheduling knobs. Chunk sizes trade steal granularity against
    # per-round dispatch/transfer latency; the device chunk is a multiple of
    # its 128-block compile bucket. SRLA_TPU_HOST_SHARE=0 disables the host
    # thread, =1 disables the device.
    _HYBRID_DEV_CHUNK = 512
    _HYBRID_HOST_CHUNK = 64

    def _encode_group_hybrid(self, pcm, spans, idxs, size, offset_lshift):
        """Work-stealing split of a large group between the device pipeline
        and the native host path. The device worker consumes chunks from the
        front of a shared queue with a one-deep software pipeline (the next
        chunk's analysis is dispatched before the current chunk's results
        are fetched, hiding transfer latency); the host thread steals from the
        back. Every block is a valid, losslessly-decodable unit from either
        path, so any split yields a correct stream and the faster side
        automatically does more.

        In the default exact device mode (kernels/exact.py) both paths emit
        byte-identical blocks — boundary-flagged blocks are host-re-derived —
        so the stream is byte-exact vs the reference and deterministic
        regardless of how the work-stealing race splits the queue. With
        SRLA_TPU_APPROX=1 the old f32 analysis is used instead: lossless and
        within ~2% of the exact compressed size, but neither reproducible
        across runs nor reference-byte-exact."""
        import os
        import threading
        import time as _time

        from . import native_decoder as nd_mod

        share = os.environ.get("SRLA_TPU_HOST_SHARE", "")
        if share == "0" or not nd_mod.available() \
                or len(idxs) < 3 * self._HYBRID_HOST_CHUNK:
            return self._encode_group_device(pcm, spans, idxs, size,
                                             offset_lshift)
        if share == "1":
            return self._encode_host_batch(pcm, spans, idxs, size,
                                           offset_lshift)


        pending = list(idxs)
        lock = threading.Lock()
        dev_taken: list[int] = []

        def take(k, from_front):
            with lock:
                k = min(k, len(pending))
                if k == 0:
                    return []
                if from_front:
                    chunk, rest = pending[:k], pending[k:]
                else:
                    chunk, rest = pending[-k:], pending[:-k]
                pending[:] = rest
                if from_front:
                    dev_taken.extend(chunk)
                return chunk

        dev_results: dict[int, bytes] = {}
        rates = {"host": None, "dev": None}  # blocks/sec, EMA

        def _ema(old, new):
            return new if old is None else 0.5 * old + 0.5 * new

        def dev_worker():
            # Guided self-scheduling: chunk sizes follow the measured
            # device/host rate ratio, so a slow device never strands more
            # than ~2 small chunks while the host drains the queue. First
            # chunks are small probes (rates unknown).
            #
            # Net-contribution gate: every CPU-second the device pipeline's
            # host glue (dispatch prep, fetches, native payload assembly)
            # burns is a CPU-second the host worker subprocess may lack.
            # The device share is worth keeping only while
            # blocks_delivered > host_rate * process_cpu_spent. Measured via
            # time.process_time (the host worker is a separate process;
            # this process's CPU is ~all device glue), stop after 2
            # consecutive net-negative chunks.
            st = None
            last = _time.perf_counter()
            cpu_last = _time.process_time()
            neg_streak = 0
            while True:
                with lock:
                    rem = len(pending)
                if rates["dev"] is None or rates["host"] is None:
                    want = 128
                else:
                    frac = rates["dev"] / (rates["dev"] + rates["host"])
                    want = int(min(self._HYBRID_DEV_CHUNK,
                                   max(64, rem * frac * 0.5)))
                if neg_streak >= 2:
                    want = 0
                chunk = take(want, True) if rem and want else []
                nxt = (self._device_dispatch(pcm, spans, chunk, size,
                                             offset_lshift)
                       if chunk else None)
                if st is not None:
                    done = self._device_finish(st[0], pcm, spans, size,
                                               offset_lshift)
                    with lock:
                        dev_results.update(done)
                    now = _time.perf_counter()
                    cpu_now = _time.process_time()
                    rates["dev"] = _ema(rates["dev"],
                                        len(st[1]) / max(now - last, 1e-3))
                    if rates["host"]:
                        # Strictly-positive economics: a chunk must deliver
                        # MORE blocks than the host worker would have
                        # produced with the parent CPU the glue burned, or
                        # it is making the encode slower.
                        worth = rates["host"] * (cpu_now - cpu_last)
                        neg_streak = (neg_streak + 1
                                      if len(st[1]) < 1.05 * worth else 0)
                    last = now
                    cpu_last = cpu_now
                if nxt is None:
                    return
                st = (nxt, chunk)

        # Host side: prefer the persistent jax-free worker subprocess — the
        # device thread and the jax runtime contend for this process's GIL;
        # the scheduler thread sleeps on the worker's pipe instead,
        # releasing the GIL. The worker is attached AFTER the device thread
        # launches: its first-use spawn imports numpy and srla_tpu and must
        # not stall the device side.
        from . import hostproc
        worker = None

        def host_encode(chunk):
            nonlocal worker
            if worker is not None:
                try:
                    worker.submit(spans, chunk, size, offset_lshift)
                    out, n_host = worker.result()
                    self.stats["host_blocks"] += n_host
                    self._report_progress(len(chunk) * size)
                    return out
                except Exception:
                    hostproc.mark_broken(self.p)
                    worker = None
            return self._encode_host_batch(pcm, spans, chunk, size,
                                           offset_lshift)

        results: dict[int, bytes] = {}
        # DAEMON thread, not a ThreadPoolExecutor: cf's atexit hook joins
        # its (non-daemon) workers, so a hung device op would block process
        # EXIT even though the encode itself already returned via host
        # racing. A daemon thread never blocks exit.
        fut = _DaemonTask(dev_worker)
        worker = hostproc.get_worker(self.p)
        if worker is not None:
            try:
                worker.set_pcm(pcm)
            except Exception:
                hostproc.mark_broken(self.p)
                worker = None
        try:
            while True:
                chunk = take(self._HYBRID_HOST_CHUNK, False)
                if not chunk:
                    break
                t0 = _time.perf_counter()
                results.update(host_encode(chunk))
                dt = max(_time.perf_counter() - t0, 1e-3)
                rates["host"] = _ema(rates["host"], len(chunk) / dt)
            # The queue is drained. A stalled device must not stall the
            # encode: race any device-held blocks on the host (every block is
            # a self-contained valid unit, so duplicates are harmless — the
            # first finisher wins) and return without joining the worker.
            try:
                fut.result(timeout=0.05)
            except TimeoutError:
                with lock:
                    have = set(results) | set(dev_results)
                    missing = [i for i in dev_taken if i not in have]
                # Wait only while the device is expected to beat a host redo
                # of its outstanding blocks; then race.
                grace = 0.05
                if missing and rates["dev"] and rates["host"]:
                    est_dev = len(missing) / rates["dev"]
                    est_redo = len(missing) / rates["host"]
                    if est_dev < est_redo:
                        grace = 1.5 * est_dev + 0.1
                try:
                    fut.result(timeout=grace)
                except TimeoutError:
                    with lock:
                        have = set(results) | set(dev_results)
                        missing = [i for i in dev_taken if i not in have]
                    if missing:
                        results.update(host_encode(missing))
        finally:
            pass  # daemon dev thread: never joined, never blocks exit
        with lock:
            got = dict(dev_results)
        for k, v in got.items():
            results.setdefault(k, v)
        # Anything still missing (race window): host-encode it now.
        still = [i for i in idxs if i not in results]
        if still:
            results.update(host_encode(still))
        return results

    def _finish_block(self, pcm, spans, i, size, params, method_b, bi, C):
        """Assemble a compress payload, applying the raw-size fallback."""
        payload = self._compress_payload(params, method_b, size, bi, C)
        raw_bits = self.p.bits_per_sample * size * C
        if 8 * len(payload) >= raw_bits:
            blk = pcm[:, spans[i][0]:spans[i][0] + size]
            return frame_block(BlockDataType.RAW, size,
                               self._raw_payload(blk.astype(np.int32), size))
        return frame_block(BlockDataType.COMPRESS, size, payload)

    def _incoming_state(self, pcm, spans, types, i, offset_lshift):
        """LPC work-buffer contents entering span i: the raw IFFT buffer left
        by the previous compress-analyzed span's last channel variant (fresh
        arena memory — zeros — when there is none)."""
        prev = None
        for j in range(i - 1, -1, -1):
            if types[j] == BlockDataType.COMPRESS:
                prev = j
                break
        if prev is None:
            return self._fresh_state()
        off, size = spans[prev]
        return self._state_from_block(pcm, off, size, offset_lshift)

    def _fresh_state(self) -> np.ndarray:
        # Fresh arena memory in the reference comes from mmap'd pages: zeros.
        return np.zeros(round_up_pow2(self.p.max_num_samples_per_block))

    def _state_from_block(self, pcm, off, size, offset_lshift) -> np.ndarray:
        """Work-buffer contents after analyzing the (even-length) block at
        (off, size): the raw IFFT buffer of its last channel variant."""
        state = self._fresh_state()
        work = pcm[:, off:off + size].astype(np.int32)
        if offset_lshift:
            work = (work >> offset_lshift).astype(np.int32)
        last = work[pcm.shape[0] - 1]
        _, raw = self._analyze_channel(last[None, :size], size,
                                       want_state=True)
        if raw is not None:
            state[:len(raw)] = raw
        return state

    # -- device group encode: on-device packing --------------------------- #

    @staticmethod
    def _min_group_rows() -> int:
        import os
        try:
            return int(os.environ.get("SRLA_TPU_MIN_GROUP_ROWS", "8"))
        except ValueError:
            return 8

    def _device_args(self, n: int):
        from .dsp.fft import round_up_pow2
        max_porder = 0
        while n % (1 << (max_porder + 1)) == 0 and max_porder < 10:
            max_porder += 1
        return dict(
            n=n, bps=self.p.bits_per_sample,
            max_params=self.preset.max_num_parameters,
            max_fixed=self.preset.lpc_order_tactics == OrderTactics.MAX_FIXED,
            fft_size=round_up_pow2(n), max_porder=max_porder)

    def _device_args_ex(self, n: int):
        return dict(self._device_args(n), ltp_order=self.p.ltp_order)

    def _device_size_ok(self, size: int) -> bool:
        """Can the device path handle this group size under the current
        config? Odd sizes need the reference's stale-work-buffer emulation;
        LTP needs fft_size >= LTP_MAX_PERIOD+1 lags (n >= 512 keeps the
        pitch autocorrelation free of stale-buffer reads, lpc.c:1509-1528).
        """
        if size % 2:
            return False
        if not (self._approx_device or self._device_exact_ok):
            return False
        if self.p.ltp_order > 0 and size < 512 and not self._approx_device:
            return False
        return True

    def _variant_stack(self, blocks: np.ndarray, n: int, offset_lshift,
                       pad_bucket: int = 0):
        B, C, _ = blocks.shape
        work = _apply_lshift(blocks, offset_lshift)
        nvar = C + (2 if C >= 2 else 0)
        V = nvar * B
        # Pad the batch axis to a bucket size so device programs are compiled
        # once per bucket, not once per file length.
        Vp = ((V + pad_bucket - 1) // pad_bucket) * pad_bucket if pad_bucket \
            else V
        stack = np.zeros((Vp, n), dtype=np.int32)
        pos = 0
        if C >= 2:
            s = (work[:, 1] - work[:, 0]).astype(np.int32)
            stack[0:B] = work[:, 0] + (s >> 1)
            stack[B:2 * B] = s
            pos = 2 * B
        for c in range(C):
            stack[pos:pos + B] = work[:, c]
            pos += B
        return stack

    @staticmethod
    def _pack_impl() -> str:
        """Residual pack of the fused encode: plain scatter on every
        platform. On the GPU it runs as fast as the scatter-free flat pack
        and compiles in half the time; on the CPU the flat pack's unrolled
        frame loop costs minutes of XLA:CPU compile per shape (PERF.md has
        the H100 A/B)."""
        return "scatter"

    def _device_dispatch(self, pcm, spans, idxs, size: int,
                         offset_lshift: int) -> dict:
        """Upload one equal-size group and dispatch its on-device analysis
        (async); returns handles for _device_finish."""
        if self._approx_device:
            from .kernels.encode import analyze_blocks_ex
        else:
            from .kernels.exact import \
                analyze_blocks_exact as analyze_blocks_ex

        C = pcm.shape[0]
        B = len(idxs)
        bps = self.p.bits_per_sample
        blocks = _gather_blocks(pcm, spans, idxs, size)
        # Pad the block axis to a bucket so device programs compile once per
        # bucket; variants are constructed ON DEVICE (halves the upload).
        Bp = ((B + 127) // 128) * 128
        # 16-bit content uploads as int16 (halves the host->device transfer).
        up_dtype = np.int16 if bps <= 16 else np.int32
        padded = np.zeros((Bp, C, size), up_dtype)
        padded[:B] = blocks
        if self.mesh is None:
            # Optionally split into concurrent row-slice uploads, rejoined
            # with one on-device concatenate (_put_concurrent).
            padded = _put_concurrent(padded)
        W = (size * (bps + 4)) // 32 + 64
        if self.mesh is not None:
            import jax
            from jax.sharding import NamedSharding, PartitionSpec
            axis = self.mesh.axis_names[0]
            nd = self.mesh.devices.size
            if Bp % nd == 0:
                padded = jax.device_put(
                    padded, NamedSharding(self.mesh,
                                          PartitionSpec(axis, None, None)))
                # Shard-balance accounting (dryrun/judge): blocks per device
                # of the GSPMD-partitioned input this group analyzes.
                self.stats["shard_rows"] = sorted(
                    s.data.shape[0] for s in padded.addressable_shards)
                self.stats["shard_devices"] = sorted(
                    s.device.id for s in padded.addressable_shards)
        from .kernels import sharded_cpu_cache_bypass
        if self._approx_device:
            args = self._device_args_ex(size)
            with sharded_cpu_cache_bypass(self.mesh):
                small, big = analyze_blocks_ex(
                    padded, np.int32(offset_lshift), C=C, **args)
            return dict(idxs=idxs, small=small, big=big, B=B, Bp=Bp, W=W,
                        C=C)
        # Exact mode: fused analysis + selection + packing — one dispatch,
        # one parameter fetch, one exact-size payload fetch per group.
        from .kernels.exact import encode_blocks_exact
        import os
        args = self._device_args(size)
        with sharded_cpu_cache_bypass(self.mesh):
            small, flat = encode_blocks_exact(
                padded, np.int32(offset_lshift), C=C, W=W,
                impl=os.environ.get("SRLA_PACK_IMPL", self._pack_impl()),
                ltp_order=self.p.ltp_order,
                svr_iter=self.p.num_svr_filter_learning_iteration,
                margins=tuple(self.preset.margin_list), **args)
        return dict(idxs=idxs, small=small, flat=flat, B=B, Bp=Bp, W=W, C=C)

    def _encode_group_device(self, pcm: np.ndarray, spans, idxs, size: int,
                             offset_lshift: int) -> dict[int, bytes]:
        """Encode one equal-size block group with on-device analysis AND
        on-device residual packing; only parameters and the compacted packed
        sections are fetched to the host.

        Large groups are split into _HYBRID_DEV_CHUNK-block chunks with a
        two-deep software pipeline: up to two chunks are dispatched before
        the oldest is fetched, so the next chunks' upload + device compute
        overlap the current chunk's D2H fetch and host assembly (dispatch is
        async; the result fetch in _device_finish is the only sync point).
        Chunks reuse one compile bucket, so this adds no new device programs.
        """
        from collections import deque

        CH = self._HYBRID_DEV_CHUNK
        results: dict[int, bytes] = {}
        pend: deque = deque()
        for lo in range(0, len(idxs), CH):
            pend.append(self._device_dispatch(
                pcm, spans, idxs[lo:lo + CH], size, offset_lshift))
            if len(pend) > 2:
                results.update(self._device_finish(
                    pend.popleft(), pcm, spans, size, offset_lshift))
        while pend:
            results.update(self._device_finish(
                pend.popleft(), pcm, spans, size, offset_lshift))
        return results

    def _device_finish(self, st: dict, pcm, spans, size: int,
                       offset_lshift: int) -> dict[int, bytes]:
        """Fetch a dispatched group's results and assemble framed blocks."""
        if "flat" in st:
            return self._device_finish_fused(st, pcm, spans, size,
                                             offset_lshift)
        return self._device_finish_approx(st, pcm, spans, size,
                                          offset_lshift)

    def _device_finish_fused(self, st: dict, pcm, spans, size: int,
                             offset_lshift: int) -> dict[int, bytes]:
        """Exact fused path: selection and packing already ran in the
        dispatch program; fetch the parameters, then exactly sum(lens_w)
        words of the compacted payload buffer, and frame the blocks."""
        import jax

        idxs = st["idxs"]
        C, B, Bp, W = st["C"], st["B"], st["Bp"], st["W"]
        bps = self.p.bits_per_sample
        raw_bits = bps * size * C
        small = jax.device_get(st["small"])
        risky_bi = np.asarray(small["risky_blk"])[:B]
        raw_blk = np.asarray(small["raw_blk"])[:B]
        method = np.asarray(small["method"])
        lens_w = np.asarray(small["lens_w"]).astype(np.int64)
        pack_ovf = np.asarray(small["pack_ovf"])
        sec_bits = small["section_bits"].astype(np.int64)
        starts = np.cumsum(lens_w) - lens_w
        total = int(lens_w.sum())
        flat = np.asarray(st["flat"][:total])          # exact-size fetch
        flat_bytes = flat.astype(">u4").tobytes()

        def row_of(bi, c):
            m = int(method[bi])
            if C == 1:
                vix = 0
            elif m == ChProcessMethod.MS:
                vix = c if c < 2 else 2 + c
            elif m == ChProcessMethod.LS and c == 1:
                vix = 1
            elif m == ChProcessMethod.SR and c == 0:
                vix = 1
            else:
                vix = 2 + c
            return vix * Bp + bi

        results: dict[int, bytes] = {}
        # Host repair: boundary-flagged blocks (decisions unproven) and rows
        # the packer could not represent (block-impl frame overflow) or that
        # exceeded the W-word section bound (lens_w forced to 0 by the
        # kernel while the section is non-raw).
        repair = set(np.flatnonzero(risky_bi).tolist())
        self.stats["repaired_blocks"] += len(repair)
        for bi in range(B):
            if bi in repair or raw_blk[bi]:
                continue
            rows = [bi * C + c for c in range(C)]
            if any(pack_ovf[r] for r in rows) \
                    or any(lens_w[r] == 0 for r in rows):
                repair.add(bi)
                self.stats["w_overflow_blocks"] += 1
        if repair:
            results.update(self._encode_host_batch(
                pcm, spans, [idxs[bi] for bi in sorted(repair)], size,
                offset_lshift))
        compress_idx = [bi for bi in range(B)
                        if not raw_blk[bi] and bi not in repair]
        self.stats["device_blocks"] += len(compress_idx)

        native_ok = False
        if compress_idx:
            from . import native_decoder as nd
            native_ok = nd.available()
        if compress_idx and native_ok:
            rows2 = np.array([[row_of(bi, c) for c in range(C)]
                              for bi in compress_idx])
            flatrows = np.array([[bi * C + c for c in range(C)]
                                 for bi in compress_idx])
            maxp = max(self.preset.max_num_parameters, 1)
            ltp_o = self.p.ltp_order
            framed, sizes = nd.assemble_blocks(
                method[compress_idx], small["pre_prev"][rows2],
                small["pre_coef"][rows2], small["orders"][rows2],
                small["rshifts"][rows2], small["coefs"][rows2][:, :, :maxp],
                flat_bytes, starts[flatrows.ravel()].astype(np.int64) * 4,
                sec_bits[rows2.ravel()], C, bps, size,
                ltp_order=ltp_o,
                ltp_periods=(small["ltp_period"][rows2] if ltp_o > 0
                             else None),
                ltp_coefs=(small["ltp_coefs"][rows2] if ltp_o > 0
                           else None))
            for k, bi in enumerate(compress_idx):
                i = idxs[bi]
                sz = int(sizes[k])
                if sz == 0:
                    blk = pcm[:, spans[i][0]:spans[i][0] + size]
                    results[i] = frame_block(
                        BlockDataType.RAW, size,
                        self._raw_payload(blk.astype(np.int32), size))
                else:
                    off = int(np.sum(sizes[:k]))
                    results[i] = framed[off:off + sz]
        elif compress_idx:
            for bi in compress_idx:
                i = idxs[bi]
                pb = PayloadBuilder(int(small["bits"][bi]) // 8 + 8)
                head = self._params_header_bits(small, method, B, bi,
                                                row_of, C)
                pb.append_bytes(head.getvalue(), head.tell_bits())
                for c in range(C):
                    r = bi * C + c
                    lo = int(starts[r]) * 4
                    hi = (int(starts[r]) + int(lens_w[r])) * 4
                    pb.append_array(
                        np.frombuffer(flat_bytes[lo:hi], np.uint8),
                        int(sec_bits[row_of(bi, c)]))
                payload = pb.getvalue()
                if 8 * len(payload) >= raw_bits:
                    blk = pcm[:, spans[i][0]:spans[i][0] + size]
                    results[i] = frame_block(
                        BlockDataType.RAW, size,
                        self._raw_payload(blk.astype(np.int32), size))
                else:
                    results[i] = frame_block(BlockDataType.COMPRESS, size,
                                             payload)
        # Raw-fallback blocks decided on device.
        for bi in range(B):
            if raw_blk[bi] and bi not in repair:
                i = idxs[bi]
                blk = pcm[:, spans[i][0]:spans[i][0] + size].astype(np.int32)
                results[i] = frame_block(BlockDataType.RAW, size,
                                         self._raw_payload(blk, size))
        self._report_progress(B * size)
        return results

    def _device_finish_approx(self, st: dict, pcm, spans, size: int,
                              offset_lshift: int) -> dict[int, bytes]:
        """Approx (f32) path: fetch analysis, select variants on host, pack
        the chosen rows in a second dispatch, and assemble framed blocks."""
        import jax

        from .kernels.encode import pack_chosen

        idxs = st["idxs"]
        big = st["big"]
        C, B, Bp, W = st["C"], st["B"], st["Bp"], st["W"]
        bps = self.p.bits_per_sample
        small = jax.device_get(st["small"])
        # Boundary-flagged variants (exact kernel only): their decisions are
        # not proven equal to the host oracle — re-derive those blocks on the
        # exact host path (any variant flag taints the whole block, since the
        # stereo argmin consults all variants).
        risky_bi = np.zeros(B, bool)
        if "risky" in small:
            nvar = C + 2 if C >= 2 else 1
            risky_bi = np.asarray(
                small["risky"]).reshape(nvar, Bp)[:, :B].any(axis=0)
        sec_bits = small["section_bits"].astype(np.int64)
        orders = small["orders"]
        maxp = max(self.preset.max_num_parameters, 1)
        coefs = small["coefs"][:, :maxp]
        ltp_o = self.p.ltp_order
        ltp_periods = small.get("ltp_period",
                                np.zeros(len(orders), np.int32))
        code_len, use_sum = self._account_bits(
            sec_bits, orders, coefs, ltp_periods, ltp_o)

        # Stereo method selection (same argmin as the host path).
        def cl(vix):
            return code_len[vix * Bp:vix * Bp + B]
        if C == 1:
            method = np.zeros(B, dtype=np.int32)
            bits = cl(0).copy()
        else:
            lens = np.stack([cl(2) + cl(3), cl(0) + cl(1),
                             cl(2) + cl(1), cl(3) + cl(1)])
            method = np.argmin(lens, axis=0).astype(np.int32)
            bits = lens[method, np.arange(B)]
        bits = ((bits + 2 + 7) // 8) * 8

        # Per-(block, channel) chosen variant rows.
        def row_of(bi, c):
            m = int(method[bi])
            if C == 1:
                vix = 0
            elif m == ChProcessMethod.MS:
                vix = c if c < 2 else 2 + c
            elif m == ChProcessMethod.LS and c == 1:
                vix = 1
            elif m == ChProcessMethod.SR and c == 0:
                vix = 1
            else:
                vix = 2 + c
            return vix * Bp + bi

        raw_bits = bps * size * C
        results: dict[int, bytes] = {}
        # Host repair of boundary-flagged blocks (exact decisions unproven).
        repair = [bi for bi in range(B) if risky_bi[bi]]
        if repair:
            self.stats["repaired_blocks"] += len(repair)
            results.update(self._encode_host_batch(
                pcm, spans, [idxs[bi] for bi in repair], size,
                offset_lshift))
        compress_idx = [bi for bi in range(B)
                        if int(bits[bi]) < raw_bits and not risky_bi[bi]]
        # Device sections truncate at W words; punt those blocks to the host.
        safe = []
        for bi in compress_idx:
            rows = [row_of(bi, c) for c in range(C)]
            if all(int(sec_bits[r]) <= W * 32 for r in rows):
                safe.append(bi)
        overflow = set(compress_idx) - set(safe)
        self.stats["w_overflow_blocks"] += len(overflow)
        for bi in overflow:
            i = idxs[bi]
            sub = self._encode_spans(pcm, [spans[i]], offset_lshift)
            results[i] = sub[0]
        compress_idx = safe
        self.stats["device_blocks"] += len(safe)

        # Pack ONLY the chosen rows on device, compacted, one transfer.
        chosen_rows = [row_of(bi, c) for bi in compress_idx for c in range(C)]
        if chosen_rows:
            K = len(chosen_rows)
            Kp = ((K + 255) // 256) * 256
            rows = np.zeros(Kp, dtype=np.int32)
            rows[:K] = chosen_rows
            lens_w = np.zeros(Kp, dtype=np.int32)
            lens_w[:K] = [(int(sec_bits[r]) + 31) // 32 for r in chosen_rows]
            starts = (np.cumsum(lens_w) - lens_w).astype(np.int32)
            total = int(lens_w.sum())
            cap = ((total + 65535) // 65536) * 65536
            import os
            flat, pack_ovf = pack_chosen(
                big["u"], big["code_type"], big["porder"], big["ks"], rows,
                starts, lens_w, n=size, W=W, cap=cap,
                impl=os.environ.get("SRLA_PACK_IMPL", "block"))
            flat, pack_ovf = jax.device_get((flat, pack_ovf))
            flat_bytes = np.asarray(flat).astype(">u4").tobytes()
            # Rows the packer could not represent (pathological codeword
            # runs beyond the block packer's frame): host-encode their
            # blocks; the assembly loops below skip them (index arithmetic
            # over flat_bytes/starts stays keyed to the full chosen list).
            pack_bad = set()
            if pack_ovf[:K].any():
                bad_rows = np.flatnonzero(pack_ovf[:K])
                pack_bad = {compress_idx[r // C] for r in bad_rows}
                self.stats["w_overflow_blocks"] += len(pack_bad)
                self.stats["device_blocks"] -= len(pack_bad)
                results.update(self._encode_host_batch(
                    pcm, spans, [idxs[bi] for bi in sorted(pack_bad)], size,
                    offset_lshift))
        else:
            pack_bad = set()

        if compress_idx:
            from . import native_decoder as nd
            native_ok = nd.available()
        if compress_idx and native_ok:
            rows2 = np.array([[row_of(bi, c) for c in range(C)]
                              for bi in compress_idx])
            maxp = max(self.preset.max_num_parameters, 1)
            framed, sizes = nd.assemble_blocks(
                method[compress_idx], small["pre_prev"][rows2],
                small["pre_coef"][rows2], small["orders"][rows2],
                small["rshifts"][rows2], small["coefs"][rows2][:, :, :maxp],
                flat_bytes, starts[:len(chosen_rows)].astype(np.int64) * 4,
                sec_bits[chosen_rows], C, bps, size,
                ltp_order=ltp_o,
                ltp_periods=(ltp_periods[rows2] if ltp_o > 0 else None),
                ltp_coefs=(small["ltp_coefs"][rows2] if ltp_o > 0 else None))
            cursor = 0
            for k, bi in enumerate(compress_idx):
                i = idxs[bi]
                sz = int(sizes[k])
                if bi in pack_bad:
                    cursor += sz
                    continue
                if sz == 0:
                    blk = pcm[:, spans[i][0]:spans[i][0] + size]
                    results[i] = frame_block(
                        BlockDataType.RAW, size,
                        self._raw_payload(blk.astype(np.int32), size))
                else:
                    results[i] = framed[cursor:cursor + sz]
                    cursor += sz
        elif compress_idx:
            for k, bi in enumerate(compress_idx):
                if bi in pack_bad:
                    continue
                i = idxs[bi]
                pb = PayloadBuilder(int(bits[bi]) // 8 + 8)
                head = self._params_header_bits(small, method, B, bi, row_of,
                                                C)
                pb.append_bytes(head.getvalue(), head.tell_bits())
                for c in range(C):
                    r = k * C + c
                    lo = int(starts[r]) * 4
                    hi = (int(starts[r]) + int(lens_w[r])) * 4
                    pb.append_array(
                        np.frombuffer(flat_bytes[lo:hi], np.uint8),
                        int(sec_bits[chosen_rows[r]]))
                payload = pb.getvalue()
                if 8 * len(payload) >= raw_bits:
                    blk = pcm[:, spans[i][0]:spans[i][0] + size]
                    results[i] = frame_block(
                        BlockDataType.RAW, size,
                        self._raw_payload(blk.astype(np.int32), size))
                else:
                    results[i] = frame_block(BlockDataType.COMPRESS, size,
                                             payload)
        # Raw-fallback blocks decided up front.
        for bi in range(B):
            if int(bits[bi]) >= raw_bits and not risky_bi[bi]:
                i = idxs[bi]
                blk = pcm[:, spans[i][0]:spans[i][0] + size].astype(np.int32)
                results[i] = frame_block(BlockDataType.RAW, size,
                                         self._raw_payload(blk, size))
        self._report_progress(B * size)
        return results

    def _params_header_bits(self, small, method, B, bi, row_of, C):
        """Method + per-channel parameter fields (everything except the
        residual sections) for one block, from the fetched device arrays."""
        w = BitWriter()
        w.put(int(method[bi]), 2)
        bps = self.p.bits_per_sample
        rows = [row_of(bi, c) for c in range(C)]
        for r in rows:
            w.put(int(sint32_to_uint32(np.int32(small["pre_prev"][r]))),
                  bps + 1)
            w.put(int(sint32_to_uint32(np.int32(small["pre_coef"][r]))),
                  PREEMPHASIS_COEF_SHIFT + 1)
        plens = self._param_lens
        slens = self._sum_lens
        for r in rows:
            o = int(small["orders"][r])
            w.put(o, LPC_COEFFICIENT_ORDER_BITWIDTH)
            w.put(int(small["rshifts"][r]), RSHIFT_LPC_COEFFICIENT_BITWIDTH)
            if o == 0:
                w.put(0, 1)
                continue
            cfs = small["coefs"][r, :o].astype(np.int32)
            uv = sint32_to_uint32(cfs)
            coef_cost = int(plens[uv].sum())
            summed = (cfs[1:].astype(np.int64)
                      + cfs[:-1].astype(np.int64)).astype(np.int32)
            suv = sint32_to_uint32(summed)
            use_sum = False
            if (suv < 256).all():
                sum_cost = int(plens[int(uv[0])]) + int(slens[suv].sum())
                use_sum = (o == 1) or (sum_cost < coef_cost)
            w.put(1 if use_sum else 0, 1)
            if use_sum:
                w.put(int(self._param_cb.codes[uv[0]]),
                      int(self._param_lens[uv[0]]))
                w.put(self._sum_cb.codes[suv], self._sum_lens[suv])
            else:
                w.put(self._param_cb.codes[uv], self._param_lens[uv])
        ltp_o = self.p.ltp_order
        for r in rows:
            per = int(small["ltp_period"][r]) if ltp_o > 0 else 0
            w.put(1 if per else 0, 1)
            if per:
                w.put((ltp_o - 1) // 2, LTP_ORDER_BITWIDTH)
                w.put(per - LTP_MIN_PERIOD, LTP_PERIOD_BITWIDTH)
                uv_l = sint32_to_uint32(
                    np.asarray(small["ltp_coefs"][r], np.int32))
                w.put(uv_l.astype(np.uint64),
                      np.full(ltp_o, LTP_COEFFICIENT_BITWIDTH))
        return w

    # -- variable block path (optimal partition search) ------------------- #

    def _encode_variable(self, pcm: np.ndarray, offset_lshift: int):
        """Variable-block encode: optimal partition per lookahead window.

        All even windows are processed in three global phases — (A) measure
        every candidate span of every window, batched by size in one call
        per size (the reference's dominant serial cost becomes one batch
        dimension across the whole file); (B) per-window Dijkstra over the
        measured costs; (C) one batched encode of all chosen spans. An odd
        final window keeps the serial reference-order evaluation (work-
        buffer state threading for bit-exactness)."""
        C, N = pcm.shape
        p = self.p
        lookahead = p.num_lookahead_samples
        windows = []
        progress = 0
        while progress < N:
            span = min(lookahead, N - progress)
            windows.append((progress, span))
            progress += span
        even_windows = [w for w in windows if w[1] % 2 == 0]

        dmin = p.min_num_samples_per_block
        dmax = p.max_num_samples_per_block
        BIG = float(1 << 24)
        adj_of: dict[int, np.ndarray] = {}
        jobs_by_size: dict[int, list] = {}
        for wo, span in even_windows:
            num_nodes = (span + dmin - 1) // dmin + 1
            adj = np.full((num_nodes, num_nodes), BIG)
            adj_of[wo] = adj
            for i in range(num_nodes):
                off = i * dmin
                for j in range(i + 1, num_nodes):
                    size = (j - i) * dmin
                    if size > dmax:
                        continue
                    jobs_by_size.setdefault(min(size, span - off),
                                            []).append((wo, i, j, wo + off))
        for size, entries in jobs_by_size.items():
            sizes = self._measure_blocks(pcm, [g for *_, g in entries],
                                         size, offset_lshift)
            for (wo, i, j, _), sz in zip(entries, sizes):
                adj_of[wo][i, j] = float(sz)

        all_spans = []
        for wo, span in even_windows:
            adj = adj_of[wo]
            num_nodes = adj.shape[0]
            path = _dijkstra(adj, num_nodes, 0, num_nodes - 1, BIG)
            parts_rev = []
            node = num_nodes - 1
            while node != 0:
                prev = path[node]
                off = prev * dmin
                parts_rev.append(min((node - prev) * dmin, span - off))
                node = prev
            off = 0
            for size in parts_rev[::-1]:
                all_spans.append((wo + off, size))
                off += size
        out = self._encode_spans(pcm, all_spans, offset_lshift)

        if windows and windows[-1][1] % 2 == 1:
            wo, span = windows[-1]
            window = pcm[:, wo:wo + span]
            last_compress = None
            for o, s in reversed(all_spans):
                blk = pcm[:, o:o + s]
                if s > self.preset.max_num_parameters and blk.any():
                    last_compress = (o, s)
                    break
            state = (self._state_from_block(pcm, *last_compress,
                                            offset_lshift)
                     if last_compress else self._fresh_state())
            parts, state = self._search_partitions(
                window, span, offset_lshift, state=state)
            off = 0
            for size in parts:
                blk = pcm[:, wo + off:wo + off + size]
                if size <= self.preset.max_num_parameters:
                    out.append(frame_block(
                        BlockDataType.RAW, size,
                        self._raw_payload(blk.astype(np.int32), size)))
                elif not blk.any():
                    out.append(frame_block(BlockDataType.SILENT, size, b""))
                else:
                    method, params, _bits = self._compute_coefficients(
                        blk[None].astype(np.int32), size, offset_lshift,
                        stale_state=state)
                    state = self._last_state
                    out.append(self._finish_block(
                        pcm, [(wo + off, size)], 0, size, params,
                        int(method[0]), 0, C))
                off += size
        return out

    def _search_partitions(self, window: np.ndarray, span: int,
                           offset_lshift: int, state=None):
        """Shortest-path search over candidate block boundaries.

        Edge (i, j) cost = measured encoded size of that span. All edge spans
        are evaluated as one batched encode per distinct size — the reference's
        dominant serial cost becomes a batch dimension here. When `state` is
        given (odd-length window), edges are evaluated serially in the
        reference's (i, j) order with work-buffer state threading, and the
        evolved state is returned alongside the partition list.
        """
        p = self.p
        dmin = p.min_num_samples_per_block
        dmax = p.max_num_samples_per_block
        num_nodes = (span + dmin - 1) // dmin + 1
        BIG = float(1 << 24)
        adj = np.full((num_nodes, num_nodes), BIG)

        # Collect unique spans to measure, batched by size.
        jobs = {}
        for i in range(num_nodes):
            for j in range(i + 1, num_nodes):
                size = (j - i) * dmin
                if size > dmax:
                    continue
                off = i * dmin
                size = min(size, span - off)
                jobs[(i, j)] = (off, size)
        if state is not None:
            C = window.shape[0]
            raw11 = lambda size: 11 + (p.bits_per_sample * size * C) // 8
            for key, (off, size) in jobs.items():  # reference (i, j) order
                blk = window[:, off:off + size]
                if size <= self.preset.max_num_parameters:
                    adj[key] = float(raw11(size))
                elif not blk.any():
                    adj[key] = 11.0
                else:
                    _m, _p, bits = self._compute_coefficients(
                        blk[None].astype(np.int32), size, offset_lshift,
                        stale_state=state, measure_only=True)
                    state = self._last_state
                    nbits = int(bits[0])
                    if nbits >= p.bits_per_sample * size * C:
                        adj[key] = float(raw11(size))
                    else:
                        adj[key] = float(11 + nbits // 8)
        else:
            by_size: dict[int, list] = {}
            for key, (off, size) in jobs.items():
                by_size.setdefault(size, []).append((key, off))
            for size, entries in by_size.items():
                sizes = self._measure_blocks(
                    window, [off for _, off in entries], size, offset_lshift)
                for (key, _), sz in zip(entries, sizes):
                    adj[key] = float(sz)

        path = _dijkstra(adj, num_nodes, 0, num_nodes - 1, BIG)
        # Walk back from goal, clip tail spans.
        parts_rev = []
        node = num_nodes - 1
        while node != 0:
            prev = path[node]
            off = prev * dmin
            size = min((node - prev) * dmin, span - off)
            parts_rev.append(size)
            node = prev
        parts = parts_rev[::-1]
        if state is not None:
            return parts, state
        return parts

    def _measure_blocks(self, window: np.ndarray, offsets, size: int,
                        offset_lshift: int) -> list[int]:
        """Measured block byte sizes for equal-size spans (batched)."""
        C = window.shape[0]
        idxs_compress = []
        sizes = [0] * len(offsets)
        raw_size = 11 + (self.p.bits_per_sample * size * C) // 8
        for k, off in enumerate(offsets):
            blk = window[:, off:off + size]
            if size <= self.preset.max_num_parameters:
                sizes[k] = raw_size
            elif not blk.any():
                sizes[k] = 11
            else:
                idxs_compress.append(k)
        if idxs_compress:
            use_dev = (self.backend == "tpu"
                       and len(idxs_compress) * max(C, 2)
                       >= self._min_group_rows()
                       and self._device_size_ok(size))
            if use_dev and not self._approx_device:
                # Exact device route: the source array crosses the link once
                # (cached across the per-size calls of one -V search); spans
                # are cut on device (kernels.exact.measure_spans_exact).
                bits = self._measure_spans_device(
                    window, [offsets[k] for k in idxs_compress], size,
                    offset_lshift)
            else:
                blocks = np.stack([window[:, offsets[k]:offsets[k] + size]
                                   for k in idxs_compress]).astype(np.int32)
                if use_dev:
                    bits = self._measure_group_device(blocks, size,
                                                      offset_lshift)
                else:
                    _method, _params, bits = self._compute_coefficients(
                        blocks, size, offset_lshift, measure_only=True)
            for bi, k in enumerate(idxs_compress):
                nbits = int(bits[bi])
                if nbits >= self.p.bits_per_sample * size * C:
                    sizes[k] = raw_size
                else:
                    sizes[k] = 11 + nbits // 8
        return sizes

    def _measure_group_device(self, blocks: np.ndarray, size: int,
                              offset_lshift: int) -> np.ndarray:
        """Block bit counts from the device analysis (fetches only the small
        per-variant arrays — residuals never cross the link). In exact mode
        the counts equal the host pipeline's; boundary-flagged blocks are
        re-measured on the host."""
        import jax

        B, C, _ = blocks.shape
        if self._approx_device:
            from .kernels.encode import analyze_variants
            stack = self._variant_stack(blocks, size, offset_lshift,
                                        pad_bucket=512)
            out = analyze_variants(stack, **self._device_args(size))
            small = jax.device_get({k: out[k] for k in
                                    ("rice_bits", "orders", "coefs")})
            small["section_bits"] = small.pop("rice_bits")
            Bp = B
            risky_bi = np.zeros(B, bool)
        else:
            from .kernels.exact import analyze_blocks_exact
            Bp = ((B + 127) // 128) * 128
            padded = np.zeros((Bp, C, size), np.int32)
            padded[:B] = blocks
            small, _big = analyze_blocks_exact(
                padded, np.int32(offset_lshift), C=C,
                ltp_order=self.p.ltp_order,
                svr_iter=self.p.num_svr_filter_learning_iteration,
                margins=tuple(self.preset.margin_list),
                **self._device_args(size))
            small = jax.device_get({k: small[k] for k in
                                    ("section_bits", "orders", "coefs",
                                     "risky", "ltp_period")})
            nvar = C + 2 if C >= 2 else 1
            risky_bi = np.asarray(
                small["risky"]).reshape(nvar, Bp)[:, :B].any(axis=0)
        maxp = max(self.preset.max_num_parameters, 1)
        ltp_periods = small.get("ltp_period",
                                np.zeros(len(small["orders"]), np.int32))
        code_len, _ = self._account_bits(
            small["section_bits"].astype(np.int64), small["orders"],
            small["coefs"][:, :maxp], ltp_periods, self.p.ltp_order)

        def cl(vix):
            return code_len[vix * Bp:vix * Bp + B]
        if C == 1:
            bits = cl(0).copy()
        else:
            lens = np.stack([cl(2) + cl(3), cl(0) + cl(1),
                             cl(2) + cl(1), cl(3) + cl(1)])
            bits = lens.min(axis=0)
        bits = ((bits + 2 + 7) // 8) * 8
        if risky_bi.any():
            self.stats["repaired_blocks"] += int(risky_bi.sum())
            _m, _p, host_bits = self._compute_coefficients(
                blocks[risky_bi], size, offset_lshift, measure_only=True)
            bits[risky_bi] = host_bits
        return bits

    def _measure_spans_device(self, window: np.ndarray, offsets, size: int,
                              offset_lshift: int) -> np.ndarray:
        """Exact device span measurement with the source resident on device.

        The -V search calls this once per span size over the same source
        array; the upload is cached on the encoder (keyed by the array's
        identity), so the samples cross the link once per search, not once
        per size. Boundary-flagged spans are re-measured on the host —
        identical bits either way."""
        import jax

        from .kernels.exact import measure_spans_exact

        C = window.shape[0]
        B = len(offsets)
        bps = self.p.bits_per_sample
        cache = getattr(self, "_mcache", None)
        if cache is None or cache[0] is not window:
            up_dtype = np.int16 if bps <= 16 else np.int32
            self._mcache = (window, jax.device_put(
                np.ascontiguousarray(window, dtype=up_dtype)))
            cache = self._mcache
        file_dev = cache[1]
        Bp = ((B + 127) // 128) * 128
        offs = np.zeros(Bp, np.int32)
        offs[:B] = offsets
        small = measure_spans_exact(
            file_dev, offs, np.int32(offset_lshift), C=C,
            ltp_order=self.p.ltp_order,
            svr_iter=self.p.num_svr_filter_learning_iteration,
            margins=tuple(self.preset.margin_list),
            **self._device_args(size))
        small = jax.device_get(small)
        nvar = C + 2 if C >= 2 else 1
        risky_bi = np.asarray(
            small["risky"]).reshape(nvar, Bp)[:, :B].any(axis=0)
        maxp = max(self.preset.max_num_parameters, 1)
        code_len, _ = self._account_bits(
            small["section_bits"].astype(np.int64), small["orders"],
            small["coefs"][:, :maxp], small["ltp_period"], self.p.ltp_order)

        def cl(vix):
            return code_len[vix * Bp:vix * Bp + B]
        if C == 1:
            bits = cl(0).copy()
        else:
            lens = np.stack([cl(2) + cl(3), cl(0) + cl(1),
                             cl(2) + cl(1), cl(3) + cl(1)])
            bits = lens.min(axis=0)
        bits = ((bits + 2 + 7) // 8) * 8
        if risky_bi.any():
            self.stats["repaired_blocks"] += int(risky_bi.sum())
            blocks = np.stack(
                [window[:, offsets[k]:offsets[k] + size]
                 for k in np.flatnonzero(risky_bi)]).astype(np.int32)
            _m, _p, host_bits = self._compute_coefficients(
                blocks, size, offset_lshift, measure_only=True)
            bits[risky_bi] = host_bits
        return bits


def _dijkstra(adj: np.ndarray, num_nodes: int, start: int, goal: int,
              big: float) -> list[int]:
    """Reference-faithful O(V^2) Dijkstra (same tie-breaking).

    Parity: SRLAOptimalBlockPartitionCalculator_ApplyDijkstraMethod
    (srla_encoder.c:249-307).
    """
    used = [False] * num_nodes
    path = [~0] * num_nodes
    cost = [big] * num_nodes
    cost[start] = 0.0
    while True:
        mincost = big
        target = start
        for i in range(num_nodes):
            if not used[i] and mincost > cost[i]:
                mincost = cost[i]
                target = i
        if target == goal:
            break
        for i in range(num_nodes):
            via = adj[target, i] + cost[target]
            if cost[i] > via:
                cost[i] = via
                path[i] = target
        used[target] = True
    return path


def _gather_blocks(pcm: np.ndarray, spans, idxs, size: int) -> np.ndarray:
    """(B, C, n) int32 view/copy of the chosen spans; zero-copy reshape when
    the spans are contiguous and equally spaced (the fixed-block common case).
    """
    offs = [spans[i][0] for i in idxs]
    if len(offs) > 1 and all(offs[k + 1] - offs[k] == size
                             for k in range(len(offs) - 1)):
        lo = offs[0]
        view = pcm[:, lo:lo + size * len(offs)]
        if view.shape[1] == size * len(offs):
            return np.swapaxes(view.reshape(pcm.shape[0], len(offs), size),
                               0, 1)
    return np.stack([pcm[:, o:o + size] for o in offs]).astype(np.int32)


def _put_concurrent(arr: np.ndarray, parts: int = 0):
    """H2D upload of a host array as `parts` concurrent row-slice transfers,
    rejoined with one on-device concatenate (an HBM-to-HBM copy). Default
    is 1 (whole-array upload); SRLA_PUT_PARTS overrides. parts<=1, small
    arrays, and the CPU backend upload whole (returned as-is: jit's
    implicit transfer handles it)."""
    import os

    env = os.environ.get("SRLA_PUT_PARTS", "")
    if env:
        try:
            parts = int(env)
        except ValueError:
            pass
    if parts <= 0:
        parts = 1
    rows = arr.shape[0]
    if parts <= 1 or arr.nbytes < (2 << 20) or rows < parts:
        return arr
    try:
        import jax
        if jax.default_backend() == "cpu":
            return arr
    except Exception:
        return arr
    import concurrent.futures as cf

    import jax.numpy as jnp
    step = -(-rows // parts)
    chunks = [arr[k * step:(k + 1) * step]
              for k in range(parts) if k * step < rows]
    with cf.ThreadPoolExecutor(len(chunks)) as ex:
        outs = list(ex.map(jax.device_put, chunks))
    return jnp.concatenate(outs, axis=0)


def _apply_lshift(blocks: np.ndarray, offset_lshift) -> np.ndarray:
    """Strip common trailing-zero bits; scalar or per-block (B,) shifts."""
    if np.ndim(offset_lshift) == 0:
        if not offset_lshift:
            return blocks.astype(np.int32)
        return (blocks >> offset_lshift).astype(np.int32)
    return (blocks >> np.asarray(offset_lshift, np.int32)[:, None, None]
            ).astype(np.int32)


def _compute_offset_lshift(pcm: np.ndarray) -> int:
    mask = 0
    orred = np.bitwise_or.reduce(
        np.bitwise_or.reduce(
            np.ascontiguousarray(pcm, np.int32).view(np.uint32), axis=1))
    mask = int(orred)
    if mask == 0:
        return 0
    return (mask & -mask).bit_length() - 1


def encode_files(pcm_list, bits_per_sample: int, sampling_rate: int,
                 preset: int = 4, max_block: int = 4096,
                 variable_divisions: int = 0, lookahead_factor: int = 4,
                 ltp_order: int = 0, svr_iterations: int = 0,
                 backend: str = "tpu", mesh=None, stats_out=None) -> list:
    """Batched multi-file encode (corpus throughput runs).

    Fixed-block encodes of files sharing (channels, offset_lshift) are
    CROSS-FILE BATCHED: their blocks join the same equal-size groups and go
    through one device dispatch per compile bucket spanning files, so the
    dispatch count does not grow with the file count. Variable-block (-V)
    and mixed-format corpora fall
    back to sequential per-file encoding; device programs are still shared
    (fixed compile buckets). Streams come back in input order.

    mesh: optional jax.sharding.Mesh — device dispatches shard the global
    (cross-file) block axis over it, so every chip sees one corpus-wide
    batch instead of per-file slices.
    """

    def make_param(C):
        return EncodeParameter(
            num_channels=C, bits_per_sample=bits_per_sample,
            sampling_rate=sampling_rate, preset=preset,
            max_num_samples_per_block=max_block,
            min_num_samples_per_block=max_block >> variable_divisions,
            num_lookahead_samples=lookahead_factor * max_block,
            ltp_order=ltp_order,
            num_svr_filter_learning_iteration=svr_iterations)

    pcms = [np.asarray(p, dtype=np.int32) for p in pcm_list]
    out: dict[int, bytes] = {}
    if variable_divisions == 0 and len(pcms) > 1:
        # Group files by (C, offset_lshift); each group encodes as one
        # virtual concatenated file whose spans never cross file boundaries.
        groups: dict[tuple, list[int]] = {}
        lshifts = [_compute_offset_lshift(p) for p in pcms]
        for i, p in enumerate(pcms):
            groups.setdefault((p.shape[0], lshifts[i]), []).append(i)
        for (C, lshift), idxs in groups.items():
            if len(idxs) == 1:
                i = idxs[0]
                out[i] = SRLAEncoder(
                    make_param(C), backend=backend,
                    mesh=mesh).encode_whole(pcms[i])
                continue
            enc = SRLAEncoder(make_param(C), backend=backend, mesh=mesh)
            cat = np.concatenate([pcms[i] for i in idxs], axis=1)
            spans = []
            ranges = []
            off = 0
            for i in idxs:
                n_i = pcms[i].shape[1]
                first = len(spans)
                for o in range(0, n_i, max_block):
                    spans.append((off + o, min(max_block, n_i - o)))
                ranges.append((i, first, len(spans)))
                off += n_i
            framed = enc._encode_spans(cat, spans, lshift)
            enc._check_repair_rate()
            if stats_out is not None and "shard_rows" in enc.stats:
                stats_out["shard_rows"] = enc.stats["shard_rows"]
                stats_out["shard_devices"] = enc.stats["shard_devices"]
            for i, lo, hi in ranges:
                header = StreamHeader(C, pcms[i].shape[1], sampling_rate,
                                      bits_per_sample, lshift, max_block,
                                      preset)
                out[i] = b"".join([encode_header(header)] + framed[lo:hi])
        return [out[i] for i in range(len(pcms))]

    enc = None
    for i, pcm in enumerate(pcms):
        param = make_param(pcm.shape[0])
        if enc is None or enc.p != param:
            enc = SRLAEncoder(param, backend=backend, mesh=mesh)
        out[i] = enc.encode_whole(pcm)
    return [out[i] for i in range(len(pcms))]


def encode(pcm: np.ndarray, bits_per_sample: int, sampling_rate: int,
           preset: int = 4, max_block: int = 4096, variable_divisions: int = 0,
           lookahead_factor: int = 4, ltp_order: int = 0,
           svr_iterations: int = 0, backend: str = "exact") -> bytes:
    """One-shot file encode (CLI-equivalent defaults)."""
    pcm = np.asarray(pcm, dtype=np.int32)
    param = EncodeParameter(
        num_channels=pcm.shape[0],
        bits_per_sample=bits_per_sample,
        sampling_rate=sampling_rate,
        preset=preset,
        max_num_samples_per_block=max_block,
        min_num_samples_per_block=max_block >> variable_divisions,
        num_lookahead_samples=lookahead_factor * max_block,
        ltp_order=ltp_order,
        num_svr_filter_learning_iteration=svr_iterations)
    return SRLAEncoder(param, backend=backend).encode_whole(pcm)
