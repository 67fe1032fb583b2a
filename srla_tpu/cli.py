"""srla-compatible command line tool.

Flags mirror the reference CLI (tools/srla_codec/srla_codec.c:39-63):
  -e/--encode, -d/--decode, -m/--mode, -B/--max-block-size,
  -V/--variable-block-divisions, -L/--lookahead-sample-factor,
  -P/--long-term-prediction, --svr-filter-learning-iteration,
  --no-checksum-check, -h/--help, -v/--version
"""

from __future__ import annotations

import argparse
import struct
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="srla-tpu",
        description="SRLA lossless audio codec (JAX implementation)")
    p.add_argument("-e", "--encode", action="store_true", help="Encode mode")
    p.add_argument("-d", "--decode", action="store_true", help="Decode mode")
    p.add_argument("-m", "--mode", type=int, default=4,
                   help="Compress mode: 0(fast), ..., 6(high compression) "
                        "(default: 4)")
    p.add_argument("-B", "--max-block-size", type=int, default=4096,
                   help="Max number of block samples (default: 4096)")
    p.add_argument("-V", "--variable-block-divisions", type=int, default=1,
                   help="Number of variable block-size divisions (default: 1)")
    p.add_argument("-L", "--lookahead-sample-factor", type=int, default=4,
                   help="Lookahead multiplier for variable block division "
                        "(default: 4)")
    p.add_argument("-P", "--long-term-prediction", type=int, default=0,
                   help="Long term (pitch) prediction order (odd, default: 0)")
    p.add_argument("--svr-filter-learning-iteration", type=int, default=0,
                   help="SVR filter learning iterations (default: 0)")
    p.add_argument("--no-checksum-check", action="store_true",
                   help="Skip checksum verification at decode")
    p.add_argument("--backend", choices=["exact", "tpu"], default="exact",
                   help="encode: exact = bit-identical host path, tpu = JAX "
                        "fast path; decode: exact = native host decode, "
                        "tpu = batched scan synthesis on device")
    p.add_argument("-v", "--version", action="version", version="srla-tpu 0.1")
    p.add_argument("input", help="Input file")
    p.add_argument("output", help="Output file")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.encode == args.decode:
        print("Please specify exactly one of -e (encode) or -d (decode).",
              file=sys.stderr)
        return 1
    import numpy as np

    from . import decoder, encoder
    from .wavio import WavData, read_audio, write_wav

    t0 = time.time()
    if args.encode:
        if not (0 <= args.mode <= 6):
            print(f"invalid compress mode: {args.mode}", file=sys.stderr)
            return 1
        wav = read_audio(args.input)
        total = wav.pcm.shape[1]

        def progress(done, _total=total):
            # Per-block progress meter (parity: the reference CLI's
            # EncodeBlockCallback display, tools/srla_codec/srla_codec.c:66).
            if sys.stderr.isatty():
                pct = min(100.0, 100.0 * done / max(_total, 1))
                print(f"\rprogress: {pct:5.1f} %", end="", file=sys.stderr)
                if done >= _total:
                    print(file=sys.stderr)

        param = encoder.EncodeParameter(
            num_channels=wav.pcm.shape[0],
            bits_per_sample=wav.bits_per_sample,
            sampling_rate=wav.sampling_rate, preset=args.mode,
            max_num_samples_per_block=args.max_block_size,
            min_num_samples_per_block=(args.max_block_size
                                       >> args.variable_block_divisions),
            num_lookahead_samples=(args.lookahead_sample_factor
                                   * args.max_block_size),
            ltp_order=args.long_term_prediction,
            num_svr_filter_learning_iteration=(
                args.svr_filter_learning_iteration))
        data = encoder.SRLAEncoder(param, backend=args.backend).encode_whole(
            np.asarray(wav.pcm, dtype=np.int32),
            progress_callback=progress)
        with open(args.output, "wb") as f:
            f.write(data)
        insize = wav.pcm.nbytes // 4 * (wav.bits_per_sample // 8) + 44
        print(f"finished: {insize} -> {len(data)} "
              f"({100.0 * len(data) / insize:6.2f} %) "
              f"[{time.time() - t0:.2f}s]")
    else:
        with open(args.input, "rb") as f:
            data = f.read()
        try:
            dec = decoder.SRLADecoder(
                check_checksum=not args.no_checksum_check,
                backend="tpu" if args.backend == "tpu" else "native")
            header, pcm = dec.decode_whole(data)
        except (ValueError, struct.error, IndexError) as e:
            print(f"decoding error: {e}", file=sys.stderr)
            return 1
        write_wav(args.output,
                  WavData(pcm, header.sampling_rate, header.bits_per_sample))
        print(f"decoded {pcm.shape[1]} samples x {pcm.shape[0]} ch "
              f"[{time.time() - t0:.2f}s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
