"""ImageFolder tree -> sharded TFRecords + DALI-style indexes (port of
``sota_imagenet_tpu/data/create_records_cli.py``; reference
create_records.py's entry point), with the shard counts as options.

    python -m sota_imagenet_tpu_torch.data.create_records_cli $IMAGENET_DIR/raw-data
"""

from __future__ import annotations

import argparse
import os

from sota_imagenet_tpu_torch.data.records import TRAIN_SHARDS, VAL_SHARDS, create_records


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("data_dir", help="dir with train/ and val/ subtrees")
    parser.add_argument("--out_dir", default=None)
    parser.add_argument("--train_shards", type=int, default=TRAIN_SHARDS)
    parser.add_argument("--val_shards", type=int, default=VAL_SHARDS)
    parser.add_argument("--workers", type=int, default=os.cpu_count())
    args = parser.parse_args(argv)
    create_records(
        args.data_dir,
        out_dir=args.out_dir,
        train_shards=args.train_shards,
        val_shards=args.val_shards,
        workers=args.workers,
    )


if __name__ == "__main__":
    main()
