"""The benchmark of kmer_mapper_tpu_torch: one run of one cell.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with an NVIDIA GPU. It prints
the set-up's parts, the window, the card and the reference on standard
error, then the numbers compared with their limits as its last lines
there, and as the last line of standard output one JSON object: ``correct``,
``attempted`` (buffers mapped), ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics from one
``torch.profiler`` session over the window), ``device``, with ``--trace 1``
``breakdown``, and ``checks``. It exits non-zero and prints no result where
PyTorch sees fewer CUDA devices than the cell asks for, or where JAX or the
JAX package was loaded into the process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

#: top-level module names that no run may load
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "kmer_mapper_tpu"})


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is forbidden (whole names:
    ``kmer_mapper_tpu_torch`` is not ``kmer_mapper_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from .spec import CHECKOUT, Spec

    cache = CHECKOUT / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)

    import torch

    spec = Spec()
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); PyTorch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from . import harness

    result = harness.run(spec, cell, args.seed, args.seconds, bool(args.trace), "cuda",
                         t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']} limit {check['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
