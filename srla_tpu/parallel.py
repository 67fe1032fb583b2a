"""Multi-chip scaling: shard the block axis over a device mesh.

The codec's natural parallel dimension is blocks (they are fully independent
in the stream format — SURVEY §5), so data parallelism over ICI is a 1-D mesh
with the variant/block axis sharded. Collectives only appear for corpus-level
reductions (total bits), which XLA lowers to an all-reduce over the mesh.
"""

from __future__ import annotations

from functools import partial

from . import kernels as _kernels  # noqa: F401  (configures the XLA cache)

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("blocks",))


def analyze_variants_sharded(mesh: Mesh, sig: np.ndarray, *, n: int, bps: int,
                             max_params: int, max_fixed: bool, fft_size: int,
                             max_porder: int):
    """Block-sharded version of kernels.encode.analyze_variants.

    sig: (V, n) with V divisible by the mesh size. Every stage is elementwise
    over the block axis, so the only communication is the final corpus-bits
    all-reduce; outputs stay sharded until fetched.
    """
    from .kernels import sharded_cpu_cache_bypass
    from .kernels.encode import analyze_variants
    spec = NamedSharding(mesh, P("blocks", None))
    sig = jax.device_put(sig, spec)
    with sharded_cpu_cache_bypass(mesh):
        out = analyze_variants(sig, n=n, bps=bps, max_params=max_params,
                               max_fixed=max_fixed, fft_size=fft_size,
                               max_porder=max_porder)
    return out


@partial(jax.jit, static_argnames=("n", "bps", "max_params", "max_fixed",
                                   "fft_size", "max_porder"))
def _train_style_step(sig, *, n, bps, max_params, max_fixed, fft_size,
                      max_porder):
    """One 'step': full analysis + corpus-level reduction (collective)."""
    from .kernels.encode import analyze_variants
    out = analyze_variants(sig, n=n, bps=bps, max_params=max_params,
                           max_fixed=max_fixed, fft_size=fft_size,
                           max_porder=max_porder)
    total_bits = jnp.sum(out["rice_bits"].astype(jnp.float32))
    return out, total_bits


def full_step_sharded(mesh: Mesh, sig: np.ndarray, *, n: int, bps: int = 16,
                      max_params: int = 32, max_fixed: bool = False,
                      fft_size: int | None = None, max_porder: int = 6):
    """Jit the full analysis step over the mesh and run it once."""
    if fft_size is None:
        fft_size = 1 << (n - 1).bit_length()
    from .kernels import sharded_cpu_cache_bypass
    spec = NamedSharding(mesh, P("blocks", None))
    sig = jax.device_put(np.asarray(sig, np.int32), spec)
    with sharded_cpu_cache_bypass(mesh):
        out, total = _train_style_step(
            sig, n=n, bps=bps, max_params=max_params, max_fixed=max_fixed,
            fft_size=fft_size, max_porder=max_porder)
    jax.block_until_ready(total)
    return out, float(total)


def encode_corpus_sharded(mesh: Mesh, pcm_list, bits_per_sample: int,
                          sampling_rate: int, preset: int = 4,
                          max_block: int = 4096, stats_out=None):
    """Encode a corpus of files with ONE GLOBAL block axis sharded over the
    mesh: files sharing (channels, offset_lshift) are cross-file batched
    (encoder.encode_files), and every device dispatch uploads its block
    batch with NamedSharding(P("blocks", ...)), so all chips work on one
    corpus-wide batch — not per-file slices. Blocks are independent
    (SURVEY §5), so the only cross-chip traffic is the gather/compaction of
    chosen packed sections.

    Returns a list of .srl byte streams, byte-exact with the single-device
    exact path.
    """
    from .encoder import encode_files

    return encode_files(pcm_list, bits_per_sample, sampling_rate,
                        preset=preset, max_block=max_block, backend="tpu",
                        mesh=mesh, stats_out=stats_out)


def decode_corpus_sharded(mesh: Mesh, streams, check_checksum: bool = True,
                          stats_out=None):
    """Decode a corpus of .srl streams with ONE GLOBAL block axis sharded
    over the mesh.

    Blocks are self-delimiting and independent, so streams with compatible
    headers (channels/bps/lshift) are fused into a single VIRTUAL stream —
    their block sections concatenated behind one header — and decoded as one
    file: all equal-size blocks across the whole corpus join the same device
    group, and GSPMD shards that global block axis (the word-machine entropy
    scan, compaction, and synthesis scans are elementwise/scan over it, so
    no collectives appear until the host fetch). The fused PCM splits back
    per file at the end.

    Returns a list of (C, N) int32 PCM arrays, bit-exact with the
    single-device / host decode.
    """
    from .constants import HEADER_SIZE
    from .decoder import SRLADecoder
    from .format import decode_header, encode_header, StreamHeader

    out: dict[int, np.ndarray] = {}
    groups: dict[tuple, list[int]] = {}
    headers = [decode_header(s) for s in streams]
    for i, h in enumerate(headers):
        groups.setdefault((h.num_channels, h.bits_per_sample,
                           h.offset_lshift, h.max_num_samples_per_block,
                           h.preset, h.sampling_rate), []).append(i)
    for key, idxs in groups.items():
        dec = SRLADecoder(check_checksum=check_checksum, backend="tpu",
                          mesh=mesh)
        if len(idxs) == 1:
            _, out[idxs[0]] = dec.decode_whole(streams[idxs[0]])
            continue
        C, bps, lshift, max_block, preset, rate = key
        total = sum(headers[i].num_samples for i in idxs)
        virtual = encode_header(StreamHeader(
            C, total, rate, bps, lshift, max_block, preset)) + b"".join(
            streams[i][HEADER_SIZE:] for i in idxs)
        _, pcm = dec.decode_whole(virtual)
        if stats_out is not None and "shard_rows" in dec.stats:
            stats_out["shard_rows"] = dec.stats["shard_rows"]
            stats_out["shard_devices"] = dec.stats["shard_devices"]
        off = 0
        for i in idxs:
            n_i = headers[i].num_samples
            out[i] = pcm[:, off:off + n_i]
            off += n_i
    return [out[i] for i in range(len(streams))]
