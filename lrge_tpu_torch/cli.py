"""Flag-compatible CLI on the PyTorch port (``python -m lrge_tpu_torch``).

Reference: `lrge/src/cli.rs`, `lrge/src/main.rs`, as ``lrge_tpu/cli.py``
reproduces them, with the port's two-set and all-vs-all strategies.
Usage: ``lrge [OPTIONS] <INPUT>``; prints the genome-size estimate (in
bp, rounded) to stdout or ``-o``.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import numpy as np
import torch

from . import __version__
from .errors import LrgeError
from .estimate import LOWER_QUANTILE, UPPER_QUANTILE
from .parallel.distributed import init_from_env
from .strategy import DEFAULT_QUERY_NUM_READS, DEFAULT_TARGET_NUM_READS, AvaBuilder, TwoSetBuilder
from .utils import create_temp_dir, format_estimate

logger = logging.getLogger("lrge")

MAX_OVERHANG_RATIO = 0.2


def _quantile(lo: float, hi: float):
    def parse(s: str) -> float:
        try:
            v = float(s)
        except ValueError:
            raise argparse.ArgumentTypeError(f"`{s}` is not a valid number")
        if not (lo < v < hi):
            raise argparse.ArgumentTypeError(
                f"Value `{s}` must be greater than {lo} and less than {hi}"
            )
        return v

    return parse


def _ratio(s: str) -> float:
    try:
        v = float(s)
    except ValueError:
        raise argparse.ArgumentTypeError(f"`{s}` is not a valid number")
    if not (0.0 <= v <= 1.0):
        raise argparse.ArgumentTypeError(f"Value `{s}` must be between 0.0 and 1.0")
    return v


def _existing_path(s: str) -> Path:
    p = Path(s)
    if not p.exists():
        raise argparse.ArgumentTypeError(f"{s} does not exist")
    return p


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="lrge",
        description="Genome size estimation from long read overlaps (PyTorch/CUDA)",
    )
    ap.add_argument("input", metavar="INPUT", type=_existing_path,
                    help="Input FASTQ, FASTA, or unaligned BAM/SAM file")
    ap.add_argument("-o", "--output", default="-", metavar="OUTPUT",
                    help="Output file for the estimate")
    ap.add_argument("-T", "--target", dest="target_num_reads", type=int, default=None,
                    metavar="INT", help="Target number of reads (two-set strategy)")
    ap.add_argument("-Q", "--query", dest="query_num_reads", type=int, default=None,
                    metavar="INT", help="Query number of reads (two-set strategy)")
    ap.add_argument("-n", "--num", dest="num_reads", type=int, default=None,
                    metavar="INT", help="Number of reads (all-vs-all strategy)")
    ap.add_argument("-P", "--platform", choices=["ont", "pb"], default="ont",
                    metavar="PLATFORM", help="Sequencing platform (ont|pb)")
    ap.add_argument("-F", "--filter-contained", action="store_true",
                    help="Exclude overlaps for internal matches")
    ap.add_argument("-t", "--threads", type=int, default=1, metavar="INT",
                    help="Number of threads to use")
    ap.add_argument("-C", "--keep-temp", action="store_true",
                    help="Don't clean up temporary files")
    ap.add_argument("-D", "--temp", dest="temp_dir", default=None, metavar="DIR",
                    help="Temporary directory for intermediate files")
    ap.add_argument("-s", "--seed", type=int, default=None, metavar="INT",
                    help="Random seed - makes the estimate repeatable")
    ap.add_argument("-8", "--inf", dest="with_infinity", action="store_true",
                    help="Median over all estimates, including infinite ones")
    ap.add_argument("-f", "--float-my-boat", dest="precise", action="store_true",
                    help="Output the estimate as a floating point number")
    ap.add_argument("--q1", dest="lower_q", type=_quantile(0.0, 0.5),
                    default=LOWER_QUANTILE, metavar="FLOAT",
                    help="Lower quantile for the confidence interval")
    ap.add_argument("--q3", dest="upper_q", type=_quantile(0.5, 1.0),
                    default=UPPER_QUANTILE, metavar="FLOAT",
                    help="Upper quantile for the confidence interval")
    ap.add_argument("--max-overhang-ratio", type=_ratio, default=MAX_OVERHANG_RATIO,
                    metavar="FLOAT", help="Max overhang/maplen ratio for -F")
    ap.add_argument("--use-min-ref", action="store_true",
                    help="Index the smaller of the Q/T sets (two-set strategy)")
    ap.add_argument("--engine", choices=["auto", "host", "device"],
                    default="auto",
                    help="Overlap engine: device (CUDA pipeline; overlaps.paf "
                         "written when -C/-D keep the temp dir), host (exact "
                         "CPU engine, always writes overlaps.paf), or auto "
                         "(default: device when a CUDA card is present and "
                         "the run has at least LRGE_AUTO_MIN_ROWS work rows, "
                         "host otherwise)")
    ap.add_argument("-q", "--quiet", action="count", default=0,
                    help="-q errors+warnings, -qq errors, -qqq nothing")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="-v debug output, -vv trace output")
    ap.add_argument("--version", action="version", version=f"%(prog)s {__version__}")
    return ap


def setup_logging(quiet: int, verbose: int) -> None:
    """Level from -v/-q stacking (`main.rs:13-30`)."""
    total = verbose - quiet
    if total == 1:
        level = logging.DEBUG
    elif total >= 2:
        level = 5  # TRACE: per-read estimates (reference -vv)
    elif total == -1:
        level = logging.WARNING
    elif total == -2:
        level = logging.ERROR
    elif total < -2:
        level = logging.CRITICAL + 10  # off
    else:
        level = logging.INFO
    logging.basicConfig(
        level=level, format="[%(asctime)s %(levelname)s %(name)s] %(message)s"
    )


def main(argv=None, device=None) -> int:
    """Run the CLI; ``device`` pins the device engine's ``torch.device``,
    or a list of devices to shard over (default: every visible CUDA
    card).  Under a multi-process launch (``LRGE_COORDINATOR``,
    ``LRGE_NUM_PROCESSES``, ``LRGE_PROCESS_ID``) every process runs the
    same deterministic pipeline and only rank 0 writes the result."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.quiet and args.verbose:
        ap.error("the argument '--quiet' cannot be used with '--verbose'")
    if args.num_reads is not None and (
        args.target_num_reads is not None or args.query_num_reads is not None
    ):
        ap.error("the argument '--num <INT>' cannot be used with '--target/--query'")
    setup_logging(args.quiet, args.verbose)
    emit_output = not init_from_env() or torch.distributed.get_rank() == 0

    tmp = create_temp_dir(args.temp_dir, args.keep_temp)
    (logger.info if args.keep_temp else logger.debug)(
        "Created temporary directory at %s", tmp.path
    )
    try:
        if args.num_reads is not None:
            logger.info("Running all-vs-all strategy with %d reads", args.num_reads)
            builder = AvaBuilder().num_reads(args.num_reads)
        else:
            t = args.target_num_reads if args.target_num_reads is not None else DEFAULT_TARGET_NUM_READS
            q = args.query_num_reads if args.query_num_reads is not None else DEFAULT_QUERY_NUM_READS
            logger.info("Running two-set strategy with %d target reads and %d query reads", t, q)
            builder = (
                TwoSetBuilder().target_num_reads(t).query_num_reads(q).use_min_ref(args.use_min_ref)
            )
        strategy = (
            builder.remove_internal(args.filter_contained, args.max_overhang_ratio)
            .engine(args.engine)
            .device_paf(args.keep_temp)
            .threads(args.threads)
            .tmpdir(tmp.path)
            .seed(args.seed)
            .platform(args.platform)
            .device(device)
            .build(args.input)
        )
        try:
            result = strategy.estimate(
                finite=not args.with_infinity,
                lower_quant=args.lower_q,
                upper_quant=args.upper_q,
            )
        except LrgeError as e:
            print(f"Error: Failed to generate estimate: {e}", file=sys.stderr)
            return 1

        if result.estimate is None:
            if args.with_infinity:
                print("Error: No estimates were generated", file=sys.stderr)
            else:
                print("Error: No finite estimates were generated", file=sys.stderr)
            return 1

        est = result.estimate
        msg = f"Estimated genome size: {format_estimate(est)}"
        if result.lower is not None and result.upper is not None:
            msg += f" (IQR: {format_estimate(result.lower)} - {format_estimate(result.upper)})"
        logger.info(msg)

        if np.isnan(est):
            out_text = "NaN\n"  # Rust's float formatting
        elif args.precise:
            # shortest f32 representation, like Rust's f32 Display
            out_text = (
                "inf\n"
                if np.isinf(est)
                else np.format_float_positional(np.float32(est), unique=True, trim="-") + "\n"
            )
        else:
            out_text = f"{est:.0f}\n"
        if not emit_output:
            pass  # a non-zero rank of a multi-process run: rank 0 writes
        elif args.output == "-":
            sys.stdout.write(out_text)
        else:
            Path(args.output).write_text(out_text)
        logger.info("Done!")
        return 0
    finally:
        tmp.cleanup()


if __name__ == "__main__":
    sys.exit(main())
