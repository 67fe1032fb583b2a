"""Incremental block-by-block decoding (the reference player's API contract).

Blocks are self-delimiting and carry all inter-block state in-band, so a
stream is decodable from any retained block offset — this is what makes both
the pull-model player and block-parallel device decode legal.
(Parity: tools/srla_player/srla_player.c:31-150.)
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from .constants import HEADER_SIZE, BlockDataType
from .decoder import SRLADecoder
from .format import StreamHeader, decode_header, parse_block_header


class StreamingDecoder:
    """Pull-model decoder: feed a .srl byte buffer, pull PCM block by block."""

    def __init__(self, data: bytes, check_checksum: bool = True):
        self.data = data
        self.header: StreamHeader = decode_header(data)
        self.offset = HEADER_SIZE
        self.progress = 0
        self._dec = SRLADecoder(check_checksum=check_checksum)

    @property
    def exhausted(self) -> bool:
        return (self.progress >= self.header.num_samples
                or self.offset >= len(self.data))

    def seek_to_block(self, byte_offset: int, sample_progress: int) -> None:
        """Resume decoding at a previously retained block boundary."""
        self.offset = byte_offset
        self.progress = sample_progress

    def tell(self) -> tuple[int, int]:
        return self.offset, self.progress

    def decode_block(self) -> Optional[np.ndarray]:
        """Decode the next block; returns (C, block_samples) int32 or None."""
        if self.exhausted:
            return None
        h = self.header
        btype, nsamples, poff, psize = parse_block_header(
            self.data, self.offset, self._dec.check_checksum)
        payload = self.data[poff:poff + psize]
        if btype == BlockDataType.SILENT:
            out = np.zeros((h.num_channels, nsamples), dtype=np.int32)
        elif btype == BlockDataType.RAW:
            out = self._dec.decode_raw_block(payload, h, nsamples)
        else:
            if self._dec._native is not None:
                out = self._dec._native.decode_block(
                    payload, h.num_channels, h.bits_per_sample, nsamples,
                    h.offset_lshift)
            else:
                bp = self._dec.decode_block_params(payload, h, nsamples)
                out = self._dec.synthesize_block(bp, h, nsamples)
        self.offset = poff + psize
        self.progress += nsamples
        return out

    def blocks(self) -> Iterator[np.ndarray]:
        while True:
            blk = self.decode_block()
            if blk is None:
                return
            yield blk


def play(path: str, blocksize: int = 4096) -> None:  # pragma: no cover
    """Minimal player: stream-decode a .srl file to the default audio device
    (requires the optional `sounddevice` package; decode is the demo here)."""
    with open(path, "rb") as f:
        data = f.read()
    dec = StreamingDecoder(data)
    try:
        import sounddevice as sd
    except ImportError as e:
        raise RuntimeError("playback requires the 'sounddevice' package; "
                           "use StreamingDecoder for pull-model decode") from e
    scale = 2.0 ** -(dec.header.bits_per_sample - 1)
    with sd.OutputStream(samplerate=dec.header.sampling_rate,
                         channels=dec.header.num_channels) as stream:
        for blk in dec.blocks():
            stream.write((blk.T * scale).astype(np.float32))
