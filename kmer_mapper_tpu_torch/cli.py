"""Command-line interface: the ``map`` and ``convert-index`` subcommands.

    python -m kmer_mapper_tpu_torch.cli map -i index.npz -f reads.fq -o counts -k 31
    python -m kmer_mapper_tpu_torch.cli convert-index -i index.npz -o index.tpuidx

Flags follow ``kmer_mapper_tpu map`` (and the reference CLI): ``-i -b -f -k
-c -o -I -r``; ``-i`` wins over ``-b`` where both are given. ``--device``
picks the torch device and defaults to ``cuda``. Where PyTorch sees no GPU,
``map`` exits with an error unless the caller passes ``--device cpu``: it
never falls back to the CPU on its own. ``convert-index`` writes the
prebuilt table (``.tpuidx.npz``, the file the JAX package reads too) and
needs no device.
"""
from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

logger = logging.getLogger(__name__)


def _parse_bool(value) -> bool:
    if isinstance(value, bool):
        return value
    return str(value).strip().lower() in ("1", "true", "yes", "y", "t")


def main(argv=None):
    logging.basicConfig(
        stream=sys.stdout, level=logging.INFO,
        format="%(asctime)s %(levelname)s: %(message)s",
    )
    return run_argument_parser(sys.argv[1:] if argv is None else argv)


def run_argument_parser(args):
    parser = argparse.ArgumentParser(
        description="Kmer Mapper on PyTorch and CUDA",
        prog="kmer_mapper_tpu_torch",
    )
    subparsers = parser.add_subparsers()
    sub = subparsers.add_parser("map", help="Map reads to a kmer index")
    sub.add_argument("-i", "--kmer-index",
                     help="kmer index: reference .npz, .tpuidx.npz, counter .npz or pickle")
    sub.add_argument("-b", "--index-bundle", help="index bundle holding a kmer_index")
    sub.add_argument(
        "-f", "--reads", required=True, help="Reads in .fa, .fq, .fa.gz, or .fq.gz format"
    )
    sub.add_argument("-k", "--kmer-size", default=31, type=int)
    sub.add_argument("-c", "--chunk-size", type=int, default=2_500_000,
                     help="N bytes to read in each chunk")
    sub.add_argument("-o", "--output-file", required=True)
    sub.add_argument("-I", "--max-hits-per-kmer", default=1000, type=int,
                     help="Ignore index kmers with more than this many hits in the index")
    sub.add_argument("-r", "--map-reverse-complements", default=False,
                     help="Also count kmers of the reverse complement of each read")
    sub.add_argument("--device", default="cuda",
                     help="torch device (default: cuda; pass --device cpu to map "
                          "on the CPU)")
    sub.set_defaults(func=_cmd_map)

    conv = subparsers.add_parser(
        "convert-index", help="Prebuild the table layout (.tpuidx.npz) from an index"
    )
    conv.add_argument("-i", "--kmer-index", required=True)
    conv.add_argument("-o", "--output-file", required=True)
    conv.set_defaults(func=_cmd_convert_index)

    if len(args) == 0:
        parser.print_help()
        sys.exit(1)
    parsed = parser.parse_args(args)
    if not hasattr(parsed, "func"):
        parser.print_help()
        sys.exit(1)
    return parsed.func(parsed)


def _cmd_map(args):
    import torch

    from . import pipeline

    if args.kmer_index is None and args.index_bundle is None:
        logger.error("Either a kmer index (-i) or an index bundle (-b) needs to be specified")
        sys.exit(1)
    if not 1 <= args.kmer_size <= 31:
        logger.error("kmer size must be in [1, 31] (62-bit hashes); got %d", args.kmer_size)
        sys.exit(1)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        logger.error("--device %s: PyTorch sees no CUDA device; pass --device cpu "
                     "to map on the CPU", args.device)
        sys.exit(1)
    logger.info("Mapping on device %s", device)
    node_counts = pipeline.map_file(
        args.kmer_index if args.kmer_index is not None else args.index_bundle,
        args.reads,
        device=device,
        k=args.kmer_size,
        chunk_size=args.chunk_size,
        max_frequency=args.max_hits_per_kmer,
        map_reverse_complements=_parse_bool(args.map_reverse_complements),
    )
    np.save(args.output_file, node_counts)
    # np.save appends .npy only when the path does not already end with it
    saved = args.output_file if str(args.output_file).endswith(".npy") else f"{args.output_file}.npy"
    logger.info("Saved node counts to %s", saved)


def _cmd_convert_index(args):
    from .index.kmer_index import load_index

    index = load_index(args.kmer_index)
    out = args.output_file if args.output_file.endswith(".npz") else args.output_file + ".npz"
    index.to_file(out)
    logger.info("Wrote index (%d unique kmers, %d buckets) to %s",
                index.n_unique, index.table.n_buckets, out)


if __name__ == "__main__":
    main()
