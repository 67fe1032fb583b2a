#!/usr/bin/env python3
"""Rebuild aggregate grid CSVs from per-file rows, intersection-safe.

The round-3 aggregates averaged each (codec, config) over whatever files
that codec happened to be measured on, so a codec measured on a subset of
the corpus showed a different-file mean — which made a bit-exact codec
look lossy next to its reference row. Here
every config's aggregate is computed ONLY over the file set common to all
codecs measured in that config; codecs missing a common-set file are
dropped from the aggregate (they stay in the per-file CSV). A `files`
column records the aggregation-set size so partial rows are impossible to
misread.

Mirrors the reference's summary semantics: its evaluate_codecs.py measures
every codec on the identical corpus, so its "total mean" rows are
same-file means by construction (/root/reference/evaluation/
evaluate_codecs.py:294-333).

Usage:
  python3 evaluation/aggregate.py PER_FILE.csv OUT.csv
"""

from __future__ import annotations

import csv
import sys
from collections import defaultdict

METRIC_COLS = ("encode_pct_rt", "decode_pct_rt", "compression_pct",
               "enc_device_blocks", "enc_host_blocks",
               "enc_repaired_blocks", "dec_device_blocks",
               "dec_host_blocks")


def aggregate(per_file_rows: list[dict]) -> list[dict]:
    # (config) -> codec -> file -> row
    grid: dict[str, dict[str, dict[str, dict]]] = defaultdict(
        lambda: defaultdict(dict))
    cfg_order: list[str] = []
    codec_order: list[str] = []
    for r in per_file_rows:
        cfg, codec = r["config"], r["codec"]
        if cfg not in cfg_order:
            cfg_order.append(cfg)
        if codec not in codec_order:
            codec_order.append(codec)
        grid[cfg][codec][r["file"]] = r

    out = []
    for cfg in cfg_order:
        by_codec = grid[cfg]
        common = None
        for files in (set(d) for d in by_codec.values()):
            common = files if common is None else (common & files)
        if not common:
            continue
        # A codec is aggregated iff it covers the whole common set (always
        # true by construction of `common`, kept as an explicit guard).
        for codec in codec_order:
            if codec not in by_codec:
                continue
            rows = [by_codec[codec][f] for f in sorted(common)
                    if f in by_codec[codec]]
            if len(rows) != len(common):
                continue
            agg = {"codec": codec, "config": cfg, "files": len(rows)}
            for col in METRIC_COLS:
                vals = [float(r[col]) for r in rows if r.get(col, "") != ""]
                if vals:
                    agg[col] = round(sum(vals) / len(vals), 3)
                    # Per-file spread for the headline metrics: codec
                    # behavior is content-dependent (a mean can hide a
                    # per-file flip — NOTES r3's -V story), so the
                    # aggregate names its own variance.
                    if col in ("encode_pct_rt", "decode_pct_rt",
                               "compression_pct") and len(vals) > 1:
                        agg[col + "_min"] = round(min(vals), 3)
                        agg[col + "_max"] = round(max(vals), 3)
            out.append(agg)
    return out


def main():
    per_file, out_path = sys.argv[1], sys.argv[2]
    with open(per_file, newline="") as f:
        rows = list(csv.DictReader(f))
    aggs = aggregate(rows)
    names: list[str] = []
    for r in aggs:
        for k in r:
            if k not in names:
                names.append(k)
    with open(out_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=names, restval="")
        w.writeheader()
        w.writerows(aggs)
    print(f"wrote {out_path}: {len(aggs)} rows "
          f"(same-file means only, `files` column = set size)")


if __name__ == "__main__":
    main()
