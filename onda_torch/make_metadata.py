"""Rebuild the weather-Cityscapes metadata JSONs by scanning a dataset's layout
(the JAX package's `tools/make_metadata.py`):

    python -m onda_torch.make_metadata --root /data/.../weather_cityscapes --kind rain
    python -m onda_torch.make_metadata --root ... --kind fog --out metadata_fog.json

It writes the table in pandas' column orientation (`data.metadata.Table`),
then prints its row count and its rows by (set, intensity). Video tables
(metadata_video.json, metadata_bern.json) cannot be derived from that layout:
their columns are image_path, label_path (null for unlabeled frames), set
("train") and scene.
"""

from __future__ import annotations

import argparse
import os
from collections import Counter

from .data.metadata import save_table, scan_weather_cityscapes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="weather_cityscapes root directory")
    ap.add_argument("--kind", choices=["rain", "fog"], default="rain")
    ap.add_argument("--out", default=None,
                    help="output JSON (default metadata[_fog].json in root)")
    ap.add_argument("--allow-unlabeled", action="store_true")
    args = ap.parse_args(argv)
    table = scan_weather_cityscapes(args.root, args.kind, require_labels=not args.allow_unlabeled)
    out = args.out or os.path.join(
        args.root, "metadata.json" if args.kind == "rain" else "metadata_fog.json")
    save_table(table, out)
    print(f"wrote {len(table)} rows to {out}")
    counts = Counter((row["set"], row["intensity"]) for row in table.rows)
    print("set    intensity  rows")
    for (set_, intensity), n in sorted(counts.items()):
        print(f"{set_:<6} {intensity:>9}  {n}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
