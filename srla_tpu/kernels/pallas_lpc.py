"""Pallas kernel (Triton route): batched LPC synthesis recurrence with fused
de-emphasis.

Device twin of kernels/decode2._lpc_scan — the sequential integer recurrence
at the heart of block decode (reference:
libs/srla_decoder/src/srla_lpc_synthesize.c SRLALPC_Synthesize):

    pred[s] = (sum_j win[s-M+j] * aligned[j] + half) >> rshift
    y[s]    = x[s]              (s == 0, or order 0)
              x[s] + y[s-1]     (0 < s < order: progressive warm-up)
              x[s] - pred[s]    (s >= order)
    fused:  out[s] = y[s] + ((out[s-1] * dcoef) >> 4)   (de-emphasis)

XLA runs `_lpc_scan` as a while loop with one trip per sample, and every trip
is at least one kernel launch on the GPU. Here the whole recurrence runs
inside one kernel launch. Rows (block x channel) are independent, so each
program owns a tile of `rows` rows with one row per thread (`rows` = 32 x
num_warps), and walks the sample axis in an in-kernel loop. The M-tap window
is a tuple of M (rows,) register vectors in the loop carry: shifting it is a
renaming of SSA values, not data movement. The coefficients are loaded once
per program. Residuals are read K samples at a time ahead of the
recurrence that consumes them, so the load latency is paid once per K
samples instead of once per sample. The loop body is unrolled over those K
samples, so K shrinks as M grows to hold the body near 1024 taps: Triton's
compile time grows with the body (on an H100, M = 256 at K = 16 took
161 s to compile; see PERF.md).

Layout: the caller transposes residuals to (n, R) so that the per-sample
load and store of a row tile are contiguous.

All arithmetic is wrapping int32, identical to the XLA scan (including the
reference's x86 shift-count quirk: rshift==0 encodes half = INT_MIN,
emulating C's `1 << (rshift-1)` under shift-count masking — see the
bit-exactness playbook in NOTES.md).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

ROWS = 32            # default row tile: one warp, one row per thread
_BODY_TAPS = 1024    # bound on K * M, the unrolled multiply-adds per trip

# Rows of the packed per-row parameter block.
_P_ORDER, _P_RSHIFT, _P_HALF, _P_DCOEF, _P_DPREV = range(5)
_NPARAM = 8          # padded to a power of two


def _tree_sum(terms):
    """Pairwise sum: log-depth dependency chain instead of a linear one."""
    terms = list(terms)
    while len(terms) > 1:
        nxt = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def samples_per_trip(M: int) -> int:
    """K: samples per loop trip (residual prefetch depth), 1..16."""
    return max(1, min(16, _BODY_TAPS // M))


def _make_kernel(nchunks: int, K: int, M: int, fuse: bool):
    def kernel(res_ref, al_ref, prm_ref, out_ref):
        al = tuple(al_ref[j] for j in range(M))          # M x (rows,)
        orders = prm_ref[_P_ORDER]
        rsh = prm_ref[_P_RSHIFT]
        half = prm_ref[_P_HALF]
        dcoef = prm_ref[_P_DCOEF]
        active = orders > 0
        zero = jnp.zeros_like(orders)

        def chunk(c, carry):
            win, yprev = carry
            base = c * K
            xs = [res_ref[base + k] for k in range(K)]
            for k in range(K):
                s = base + k
                x = xs[k]
                acc = _tree_sum(w * a for w, a in zip(win, al)) + half
                pred = acc >> rsh
                nv = jnp.where(s == 0, x,
                               jnp.where(s < orders, x + win[-1], x - pred))
                nv = jnp.where(active, nv, x)
                win = win[1:] + (nv,)
                if fuse:
                    yprev = nv + ((yprev * dcoef) >> 4)
                    out_ref[s] = yprev
                else:
                    out_ref[s] = nv
            return win, yprev

        jax.lax.fori_loop(0, nchunks, chunk,
                          ((zero,) * M, prm_ref[_P_DPREV]))

    return kernel


@partial(jax.jit, static_argnames=("M", "fuse", "rows", "interpret"))
def _lpc_kernel_T(resT, alT, prm, *, M: int, fuse: bool, rows: int,
                  interpret: bool):
    npad, Rp = resT.shape
    K = samples_per_trip(M)
    return pl.pallas_call(
        _make_kernel(npad // K, K, M, fuse),
        out_shape=jax.ShapeDtypeStruct((npad, Rp), jnp.int32),
        grid=(Rp // rows,),
        in_specs=[
            pl.BlockSpec((npad, rows), lambda i: (0, i)),
            pl.BlockSpec((M, rows), lambda i: (0, i)),
            pl.BlockSpec((_NPARAM, rows), lambda i: (0, i)),
        ],
        out_specs=pl.BlockSpec((npad, rows), lambda i: (0, i)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(rows // 32, 1), num_stages=1),
        interpret=interpret,
        name="srla_lpc_synthesis",
    )(resT, alT, prm)


def lpc_synthesis(res: jnp.ndarray, aligned: jnp.ndarray,
                  orders: jnp.ndarray, rshifts: jnp.ndarray,
                  n: int, M: int, dcoef=None, dprev=None, *,
                  rows: int = ROWS, interpret: bool = False) -> jnp.ndarray:
    """Drop-in twin of decode2._lpc_scan (same args, same semantics).

    res (R, n) int32, aligned (R, M) int32 right-aligned coefficients,
    orders/rshifts (R,) int32; dcoef/dprev fuse the de-emphasis recurrence.
    Rows are padded to a multiple of the row tile (padded rows have order 0
    and pass residuals through); the sample axis is padded to a multiple of
    K (padded samples compute values past n that are sliced off). `rows`
    is a power of two; `interpret` runs the kernel on the CPU for tests.
    """
    if rows & (rows - 1):
        raise ValueError(f"row tile must be a power of two, got {rows}")
    R = res.shape[0]
    Rp = -(-R // rows) * rows
    K = samples_per_trip(M)
    npad = -(-n // K) * K
    fuse = dcoef is not None

    half = jnp.where(rshifts > 0,
                     jnp.int32(1) << jnp.maximum(rshifts - 1, 0),
                     jnp.int32(-2147483648))
    z = jnp.zeros((R,), jnp.int32)
    prm = jnp.stack([jnp.asarray(v, jnp.int32) for v in (
        orders, rshifts, half, dcoef if fuse else z,
        dprev if fuse else z)] + [z] * (_NPARAM - 5))
    prm = jnp.pad(prm, ((0, 0), (0, Rp - R)))
    resT = jnp.pad(jnp.asarray(res, jnp.int32),
                   ((0, Rp - R), (0, npad - n))).T            # (npad, Rp)
    alT = jnp.pad(jnp.asarray(aligned, jnp.int32), ((0, Rp - R), (0, 0))).T
    outT = _lpc_kernel_T(resT, alT, prm, M=M, fuse=fuse, rows=rows,
                         interpret=interpret)
    return outT.T[:R, :n]
