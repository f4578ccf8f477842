"""Standalone feature-indexing CLI: scan input data for its distinct
features and write partitioned index-map stores for later runs.

Port of ``photon_ml_tpu/cli/feature_indexing_job.py`` (reference:
FeatureIndexingJob.scala:176-204), with the same flags. It touches no
device, so it takes no ``--device``, and it needs no compile cache.
GAME mode (``--feature-shard-id-to-feature-section-keys-map``) writes one
namespace per shard; legacy mode one ``global`` namespace over the
``features`` field. ``--offheap true`` (the default) also writes the
memmap-served store the drivers read through ``--offheap-indexmap-dir``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from photon_ml_tpu_torch.cli.args import parse_section_keys_map
from photon_ml_tpu_torch.io.data_format import (
    RESPONSE_PREDICTION_FIELD_NAMES,
    TRAINING_EXAMPLE_FIELD_NAMES,
)
from photon_ml_tpu_torch.io.feature_index_job import build_feature_index
from photon_ml_tpu_torch.utils import parse_flag


def parse_args(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="feature-indexing-job-torch")
    p.add_argument("--input-paths", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--num-partitions", type=int, default=1)
    p.add_argument("--add-intercept", default="true")
    p.add_argument("--feature-shard-id-to-feature-section-keys-map",
                   default="", help="GAME mode: per-shard section keys")
    p.add_argument("--format", default="TRAINING_EXAMPLE",
                   choices=["TRAINING_EXAMPLE", "RESPONSE_PREDICTION"],
                   help="legacy mode: which field naming to scan")
    p.add_argument("--offheap", default="true",
                   help="also write the memmap-served off-heap store "
                        "(read through --offheap-indexmap-dir)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ns = parse_args(argv if argv is not None else sys.argv[1:])
    shard_sections = parse_section_keys_map(
        ns.feature_shard_id_to_feature_section_keys_map) or None
    field_names = None
    if shard_sections is None:
        field_names = (TRAINING_EXAMPLE_FIELD_NAMES
                       if ns.format == "TRAINING_EXAMPLE"
                       else RESPONSE_PREDICTION_FIELD_NAMES)
    built = build_feature_index(
        ns.input_paths, ns.output_dir,
        feature_shard_sections=shard_sections, field_names=field_names,
        add_intercept=parse_flag(ns.add_intercept),
        num_partitions=ns.num_partitions, offheap=parse_flag(ns.offheap))
    for name, imap in built.items():
        print(f"{name}: {len(imap)} features")


if __name__ == "__main__":
    main()
