"""MSB-first bit I/O.

The writer is *vectorized*: callers append (value, nbits) codewords (possibly as
whole numpy arrays), and the final byte stream is produced in one shot with a
prefix-sum bit scatter + ``np.packbits``. This replaces the byte-serial staging
engine of classic codecs (reference parity: libs/bit_stream/include/bit_stream.h)
with the formulation that also maps onto the device (codeword-length computation +
prefix-sum pack).

The reader keeps an explicit bit cursor over an unpacked bit array, with an
index of one-positions so unary (zero-run) codes decode in O(log n).

Stream semantics (normative for the .srl format):
  - ``put(val, n)`` emits the low ``n`` bits of ``val``, most significant first.
  - ``put_zero_run(r)`` emits ``r`` zero bits followed by a terminating 1.
  - ``flush`` pads with zero bits to the next byte boundary.
"""

from __future__ import annotations

import numpy as np

_POW2 = (1 << np.arange(63, -1, -1, dtype=np.uint64)).astype(np.uint64)


class BitWriter:
    """Collects codewords; packs them to bytes on demand."""

    def __init__(self):
        self._vals: list[np.ndarray] = []
        self._nbits: list[np.ndarray] = []

    def put(self, val, nbits) -> None:
        """Append codeword(s). Scalars or equal-length arrays. nbits in [0, 32]."""
        v = np.atleast_1d(np.asarray(val, dtype=np.uint64))
        n = np.broadcast_to(np.atleast_1d(np.asarray(nbits, dtype=np.int64)), v.shape)
        mask = n > 0
        if not mask.all():
            v, n = v[mask], n[mask]
        if v.size:
            # Keep only the low n bits of each value.
            v = v & ((np.uint64(1) << n.astype(np.uint64)) - np.uint64(1))
            self._vals.append(v)
            self._nbits.append(np.asarray(n))

    def put_packed(self, buf: np.ndarray, nbits: int) -> None:
        """Append an already-packed MSB-first byte buffer of nbits bits."""
        if nbits <= 0:
            return
        nwords = (nbits + 31) // 32
        padded = np.zeros(nwords * 4, dtype=np.uint8)
        padded[:len(buf)] = buf[:min(len(buf), nwords * 4)]
        words = padded.view(">u4").astype(np.uint64)
        widths = np.full(nwords, 32, dtype=np.int64)
        rem = nbits - 32 * (nwords - 1)
        widths[-1] = rem
        words[-1] >>= np.uint64(32 - rem)
        self._vals.append(words)
        self._nbits.append(widths)

    def put_zero_run(self, runlength) -> None:
        """Emit runlength zeros then a 1 (vectorized over an array of runs)."""
        r = np.atleast_1d(np.asarray(runlength, dtype=np.int64))
        total = r + 1  # bits including terminating 1
        if (total <= 32).all():
            self.put(np.ones_like(r), total)
            return
        for run in r:
            n = int(run) + 1
            while n > 32:
                self.put(0, 31)
                n -= 31
            self.put(1, n)

    def tell_bits(self) -> int:
        return int(sum(int(n.sum()) for n in self._nbits))

    def getvalue(self) -> bytes:
        """Pack all appended codewords to a zero-padded byte string."""
        if not self._vals:
            return b""
        vals = np.concatenate(self._vals)
        nbits = np.concatenate(self._nbits)
        total_bits = int(nbits.sum())
        offsets = np.cumsum(nbits) - nbits
        # One row per output bit: which codeword, and which bit within it.
        word_id = np.repeat(np.arange(vals.size), nbits)
        pos_in_word = np.arange(total_bits, dtype=np.int64) - np.repeat(offsets, nbits)
        shift = (np.repeat(nbits, nbits) - 1 - pos_in_word).astype(np.uint64)
        bits = ((np.repeat(vals, nbits) >> shift) & np.uint64(1)).astype(np.uint8)
        return np.packbits(bits).tobytes()


class BitReader:
    """Bit cursor over a byte buffer (MSB-first)."""

    def __init__(self, data: bytes | np.ndarray):
        buf = np.frombuffer(bytes(data), dtype=np.uint8)
        self._bits = np.unpackbits(buf)
        self._ones = np.flatnonzero(self._bits)
        self.pos = 0

    def get(self, nbits: int) -> int:
        """Read nbits (<=64) and return them right-aligned."""
        if nbits == 0:
            return 0
        chunk = self._bits[self.pos:self.pos + nbits]
        self.pos += nbits
        return int(chunk.astype(np.uint64) @ _POW2[64 - nbits:])

    def get_zero_run(self) -> int:
        """Read zeros until the next 1 (consuming it); return the zero count."""
        i = np.searchsorted(self._ones, self.pos)
        if i >= len(self._ones):
            raise ValueError("insufficient data")
        one_pos = int(self._ones[i])
        run = one_pos - self.pos
        self.pos = one_pos + 1
        return run

    def flush(self) -> None:
        """Align the cursor to the next byte boundary."""
        self.pos = (self.pos + 7) & ~7

    def tell_bytes(self) -> int:
        return self.pos >> 3


def sint32_to_uint32(x):
    """Zigzag fold: signed -> unsigned, order-preserving by magnitude."""
    x = np.asarray(x, dtype=np.int32)
    with np.errstate(over="ignore"):
        return ((-(x < 0).astype(np.int32)) ^ (x << 1)).astype(np.uint32)


def uint32_to_sint32(u):
    """Inverse zigzag fold."""
    u = np.asarray(u, dtype=np.uint32)
    return ((u >> 1).astype(np.int32)) ^ (-(u & 1).astype(np.int32))
