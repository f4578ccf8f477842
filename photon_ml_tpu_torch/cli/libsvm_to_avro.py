"""LibSVM text -> TrainingExampleAvro converter.

Port of ``photon_ml_tpu/cli/libsvm_to_avro.py`` (reference:
dev-scripts/libsvm_text_to_trainingexample_avro.py), with its flags and
records: a LibSVM file or part directory, parsed by the port's native
parser, becomes the Avro container the legacy driver trains on. Features
are named by their literal LibSVM index (1-based unless
``--zero-based``), term empty. The conversion is host work, but the
command takes ``--device`` like every entry point of the port (default
``cuda``) and refuses to start without CUDA unless given ``cpu``, so a
pipeline meant for the card fails at its first step on a host without
one.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from photon_ml_tpu_torch.cli.args import add_device_flag
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.io import schemas
from photon_ml_tpu_torch.io.avro import write_container
from photon_ml_tpu_torch.io.data_format import load_libsvm
from photon_ml_tpu_torch.utils import parse_flag


def parse_args(argv: Sequence[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="libsvm-to-avro-torch",
        description="Convert LibSVM text data to TrainingExampleAvro")
    p.add_argument("--input-path", required=True,
                   help="LibSVM file or part directory")
    p.add_argument("--output-path", required=True,
                   help="Avro container file to write")
    p.add_argument("--feature-dimension", type=int, required=True)
    p.add_argument("--zero-based", default="false",
                   help="LibSVM indices start at 0 instead of 1")
    p.add_argument("--binarize-labels", default="true",
                   help="map labels >0 to 1 else 0; false keeps raw "
                        "regression targets")
    add_device_flag(p)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ns = parse_args(argv if argv is not None else sys.argv[1:])
    resolve_device(ns.device)
    zero_based = parse_flag(ns.zero_based)
    data = load_libsvm(ns.input_path, ns.feature_dimension,
                       zero_based=zero_based, use_intercept=False,
                       binarize_labels=parse_flag(ns.binarize_labels))
    csr = data.features.tocsr()
    name_shift = 0 if zero_based else 1
    indptr, idx, vals = csr.indptr, csr.indices, csr.data
    names = [str(j + name_shift) for j in range(ns.feature_dimension)]

    def records():
        for i in range(data.num_samples):
            lo, hi = indptr[i], indptr[i + 1]
            yield {
                "uid": str(i),
                "label": float(data.labels[i]),
                "features": [{"name": names[j], "term": "",
                              "value": float(v)}
                             for j, v in zip(idx[lo:hi], vals[lo:hi])],
                "metadataMap": None,
                "weight": float(data.weights[i]),
                "offset": float(data.offsets[i]),
            }

    write_container(ns.output_path, schemas.TRAINING_EXAMPLE, records())
    print(f"{data.num_samples} records -> {ns.output_path}")


if __name__ == "__main__":
    main()
